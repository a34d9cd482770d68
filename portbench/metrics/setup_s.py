"""setup_s: from the start of the process to the start of the window:
imports, kernel builds (first run in a checkout), the corpus made and
added, the query set, the warm-up of every shape the mix sends."""


def read(run):
    return run.setup_s

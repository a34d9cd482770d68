"""device_mem_gib: torch.cuda.max_memory_allocated() over the window (the
peak was reset at its start): the resident index and the search workspace."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2**30

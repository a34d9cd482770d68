"""flush_ms.c256: the mean host-clock time of one index.search that the
service flushed in the window (the proxy's span around the tier's call)."""


def read(run):
    if run.outcome.service_stats is None:
        return None
    calls = run.calls_in_window()
    return 1e3 * sum(c[2] - c[1] for c in calls) / len(calls) if calls else None

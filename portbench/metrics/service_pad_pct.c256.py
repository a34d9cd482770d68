"""service_pad_pct.c256: the service's padding, in percent of the rows the
tier received over the run: 1 - (queries the service flushed, its own
ServiceStats) / (rows the proxy passed on)."""


def read(run):
    stats = run.outcome.service_stats
    passed = sum(c[0] for c in run.calls)
    if not stats or not passed:
        return None
    return 100.0 * (1.0 - stats["queries"] / passed)

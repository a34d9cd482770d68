"""service_avg_batch.c256: queries per flush of the QueryService over the
window (its own ServiceStats counters, queries / batches)."""


def read(run):
    stats = run.outcome.service_stats
    if not stats or not stats["batches"]:
        return None
    return stats["queries"] / stats["batches"]

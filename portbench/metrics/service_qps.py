"""service_qps: `qps`, in the cells whose clients go through QueryService.
Its runs spread several times as widely as the single client's, so it is
a metric of its own, with a bound of its own."""

from portbench.readers import answered_per_s as read  # noqa: F401

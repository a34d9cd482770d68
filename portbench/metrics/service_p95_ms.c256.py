"""service_p95_ms.c256: `latency_p95_ms` through QueryService. With every
client waiting on its answer, the mean latency is clients / service_qps,
which that bound holds; the tail beyond it swings from run to run with
how the service splits its rounds, so it is read here and not bounded."""

from portbench.readers import p95_ms as read  # noqa: F401

"""latency_p95_ms: the 95th percentile, over every query answered inside the
window, of its time from submission to answer on the client's clock."""

from portbench.readers import p95_ms as read  # noqa: F401

"""queue_wait_ms.c256: a query's mean wait in QueryService from its submit
to the take of its batch, read from the program's own `service.collect`
spans inside the window (summed waits over rows; `portbench/spans.py`)."""

from portbench.spans import queue_wait_ms as read  # noqa: F401

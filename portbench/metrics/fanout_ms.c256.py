"""fanout_ms.c256: the mean of the program's `service.fanout` spans inside
the window: one flush's futures set, with the client callbacks they run
inline (`portbench/spans.py`)."""

from portbench.spans import fanout_ms as read  # noqa: F401

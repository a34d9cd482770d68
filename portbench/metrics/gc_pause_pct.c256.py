"""gc_pause_pct.c256: the program's `gc.full` spans (full collections,
recorded by its gc hook) inside the window over the window, in percent
(`portbench/spans.py`)."""

from portbench.spans import gc_pause_pct as read  # noqa: F401

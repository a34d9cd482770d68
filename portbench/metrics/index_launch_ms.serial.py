"""The mean, over the program's `index.search` spans inside the window, of
the time from the search's start to its `index.copy_back`'s: the query's
upload, its preparation and the kernels' launches, before the tier waits
for the device (`portbench/spans.py`)."""

from portbench.spans import index_launch_ms as read  # noqa: F401

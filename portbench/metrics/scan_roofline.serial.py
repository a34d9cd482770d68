"""The least time of the window's index.search calls (`roofline.py`, from the
shapes each call received) over the device time of every kernel, copy and
set they launched (device trace), in percent."""

from portbench.readers import scan_roofline as read  # noqa: F401

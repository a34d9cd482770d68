"""The share of the traced window in which nothing ran on the device:
1 - (union of device activity / window), in percent."""

from portbench.readers import device_idle_pct as read  # noqa: F401

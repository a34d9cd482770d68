"""index_host_ms.serial: the mean, over the window's index.search calls, of
the call's host-clock span less the device time of what ran during it
(device trace): the tier's host side of one search."""

from portbench.readers import index_host_ms as read  # noqa: F401

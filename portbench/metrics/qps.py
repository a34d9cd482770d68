"""qps: queries answered inside the window over the window's seconds, in the
cells of one client calling the tier itself."""

from portbench.readers import answered_per_s as read  # noqa: F401

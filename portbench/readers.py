"""What the metric readers (`metrics/<name>.py`) share.

Each reader is `read(run) -> float | None` over the `harness.Run` of one
run: the outcome of the window, the tier calls the proxy recorded, and,
in a traced run, the device trace. None means the run holds nothing to
read, and the metric is left out of the result.
"""

from __future__ import annotations

import numpy as np

from portbench.roofline import least_time_s


def answered_per_s(run) -> float:
    """Queries answered inside the window over the window's seconds."""
    return len(run.outcome.latencies_in_window()) / run.seconds


def p95_ms(run):
    """The 95th percentile of every answer inside the window, submission to
    answer on the client's clock."""
    lat = run.outcome.latencies_in_window() * 1e3
    return float(np.percentile(lat, 95)) if lat.size else None


def scan_roofline(run):
    """The least time of the tier calls wholly inside the window over the
    device time of the activity that ran during them, in percent."""
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    device_s = sum(tr.call_device_s())
    if device_s <= 0:
        return None
    cfg = run.cell.config
    least = sum(least_time_s(cfg["scoring"], int(cfg["n_rows"]), int(cfg["dim"]), rows,
                             int(cfg["k"])) for _, _, rows in tr.calls)
    return 100.0 * least / device_s


def index_host_ms(run):
    """Mean over the tier calls wholly inside the window of the call's span
    less the device time of the activity that ran during it."""
    tr = run.trace
    if tr is None or not tr.calls or not tr.device:
        return None
    device = tr.call_device_s()
    return 1e3 * sum((e - s) - d for (s, e, _), d in zip(tr.calls, device)) / len(tr.calls)


def device_idle_pct(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)

"""The device trace of a `--trace 1` run.

`torch.profiler` traces CPU and CUDA activity over the window. The harness
marks the window with one span (`portbench.window`, entered on the thread
that runs the traffic just before the window's clock starts) and nothing
else: spans opened on the worker threads of `QueryService` are not in the
trace (the profiler records functions only on the thread that started
it), so every tier call is placed on the trace's clock from the proxy's
host clock, shifted by the window span's start. After the window the
trace is exported to a temporary file, read and deleted.

From it come the device's busy intervals (kernels, copies, sets) and, for
each tier call wholly inside the window, the device time of the activity
that started during the call (a call waits for its results, so what it
launched runs inside it; in the service, calls of other workers that
overlap it share that time).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Tuple

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    """Times in seconds on the trace's clock."""
    window: Tuple[float, float]
    device: List[Tuple[float, float, str]]   # (start, end, name), overlapping the window
    calls: List[Tuple[float, float, int]]    # (start, end, rows passed), wholly in the window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> List[Tuple[float, float]]:
        """The union of device activity, clipped to the window, merged."""
        lo, hi = self.window
        merged: List[List[float]] = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in self.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if hi > t:
            gaps.append((t, hi))
        return gaps

    def in_calls(self) -> List[List[float]]:
        """The union of the calls' intervals, merged, in start order."""
        merged: List[List[float]] = []
        for s, e, _ in sorted(self.calls):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def call_device_s(self) -> List[float]:
        """Per call (in `calls` order): the device seconds of the activity
        that started while it was open; with overlapping calls, the device
        time of every call of the overlap lands on the first."""
        starts = [s for s, _, _ in self.calls]
        order = sorted(range(len(self.calls)), key=lambda i: starts[i])
        sorted_starts = [starts[i] for i in order]
        out = [0.0] * len(self.calls)
        for s, e, _ in self.device:
            j = bisect.bisect_right(sorted_starts, s) - 1
            while j >= 0:
                i = order[j]
                if self.calls[i][1] >= s:
                    out[i] += e - s
                    break
                if sorted_starts[j] < s - 1.0:
                    break
                j -= 1
        return out


class Tracer:
    """torch.profiler over the window, CPU and CUDA activity."""

    def __init__(self):
        import torch

        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def read(self, t_start: float, seconds: float, calls) -> Trace:
        """The trace, with the window [t_start, t_start + seconds] and the
        tier calls (rows passed, t0, t1) given on the host clock."""
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return parse(events, t_start, seconds, calls)


def parse(events: List[dict], t_start: float, seconds: float, calls) -> Trace:
    """Trace of chrome-trace events (microseconds), in seconds."""
    device, anchor = [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        start = float(e["ts"]) * 1e-6
        if cat in DEVICE_CATS:
            device.append((start, start + float(e.get("dur", 0)) * 1e-6, name))
        elif cat == "user_annotation" and name == WINDOW_SPAN:
            anchor = start
    if anchor is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    lo, hi = anchor, anchor + seconds
    shift = anchor - t_start
    placed = [(t0 + shift, t1 + shift, rows) for rows, t0, t1 in calls
              if t_start <= t0 and t1 <= t_start + seconds]
    return Trace(window=(lo, hi), device=[d for d in device if d[1] > lo and d[0] < hi],
                 calls=placed)


def breakdown(trace: Trace, outside_search: str, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing: inside a tier call, or not (`outside_search` says
    what it was then doing)."""
    by_op: Dict[str, float] = defaultdict(float)
    lo, hi = trace.window
    for s, e, name in trace.device:
        by_op[name[:160]] += min(e, hi) - max(s, lo)
    spans = trace.in_calls()
    span_starts = [s for s, _ in spans]
    idle: Dict[str, float] = defaultdict(float)
    longest: Dict[str, float] = defaultdict(float)
    for s, e in trace.idle_gaps():
        mid = 0.5 * (s + e)
        j = bisect.bisect_right(span_starts, mid) - 1
        label = "index.search open" if j >= 0 and spans[j][1] >= mid else outside_search
        idle[label] += e - s
        longest[label] = max(longest[label], e - s)
    gaps = [[f"{label}: all", sec] for label, sec in idle.items()]
    gaps += [[f"{label}: longest", sec] for label, sec in longest.items()]
    return {
        "device_ops": sorted(([n, v] for n, v in by_op.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(gaps, key=lambda x: -x[1])[:top],
    }

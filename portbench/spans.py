"""The program's own spans in a run's window: what the `program_span`
readers share, and a report of one run by span.

The port records its host steps in one process-global ring
(`codegraph_tpu_torch/utils/perfmon.py`) on `time.perf_counter_ns()`, the
clock of the window (`Outcome.t_start`) and of the proxy's calls. A reader
takes the records that overlap the window and, in a traced run, puts them
on the trace's clock with the shift `trace.py` gives the proxy's calls:
`trace.window[0] - outcome.t_start`. A program without the recorder (an
older commit) reads None, as does a window of which the ring overwrote a
record.

    python portbench/spans.py --workload <cell> --seed <n> --seconds <s> [--trace 0|1] [--recorder 0|1]

runs one whole run of the cell as `run.py` makes it and prints one line of
JSON: the cell's metrics, and with `--trace 1` the device's idle time by
the span the host had open, each span's count and mean in the window, the
device operations and copies a tier call ran, and the cost of one span
pair. `--recorder 0` switches the recorder off for the run (the on-off
comparison). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import heapq
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

NS = 1e-9


def _window_ns(run) -> Tuple[int, int]:
    return int(run.outcome.t_start * 1e9), int(run.outcome.t_end * 1e9)


def window_records(run) -> Optional[list]:
    """The recorder's records overlapping the run's window, by start; None
    where the program has no recorder or the ring lost a record that
    reached into the window."""
    try:
        from codegraph_tpu_torch.utils import perfmon
    except ImportError:
        return None
    snapshot = getattr(perfmon, "snapshot", None)
    if snapshot is None:
        return None
    snap = snapshot(*_window_ns(run))
    return snap.records if snap.complete else None


def inside(run, records, name: str) -> list:
    """The records named `name` wholly inside the window."""
    lo, hi = _window_ns(run)
    return [r for r in records if r.name == name and lo <= r.t0 and r.t1 <= hi]


# -- the readers of metrics/ ---------------------------------------------------

def queue_wait_ms(run):
    """A query's mean wait from its submit to its batch's take: the
    `service.collect` spans' summed waits (m, µs) over their rows (n)."""
    records = window_records(run)
    if records is None:
        return None
    collects = inside(run, records, "service.collect")
    rows = sum(r.n for r in collects)
    return sum(r.m for r in collects) / rows / 1e3 if rows else None


def fanout_ms(run):
    """The mean `service.fanout` span: the futures of one flush set, with
    the callbacks they run."""
    records = window_records(run)
    if records is None:
        return None
    spans = inside(run, records, "service.fanout")
    return sum(r.t1 - r.t0 for r in spans) / len(spans) / 1e6 if spans else None


def gc_pause_pct(run):
    """The `gc.full` spans' time inside the window over the window, in percent."""
    records = window_records(run)
    if records is None:
        return None
    lo, hi = _window_ns(run)
    paused = sum(min(r.t1, hi) - max(r.t0, lo) for r in records if r.name == "gc.full")
    return 100.0 * paused / (hi - lo)


def index_launch_ms(run):
    """Mean over the `index.search` spans inside the window of the time
    from its start to its `index.copy_back`'s: upload, prepare and the
    launches, before the tier waits for the device."""
    records = window_records(run)
    if records is None:
        return None
    copy_back = {r.parent: r.t0 for r in records if r.name == "index.copy_back"}
    gaps = [copy_back[s.id] - s.t0 for s in inside(run, records, "index.search")
            if s.id in copy_back]
    return sum(gaps) / len(gaps) / 1e6 if gaps else None


# -- the device's idle time by span --------------------------------------------

def on_trace_clock(run, records) -> List[tuple]:
    """(start, end, record) of each record, in seconds on the trace's clock."""
    shift = run.trace.window[0] - run.outcome.t_start
    return [(r.t0 * NS + shift, r.t1 * NS + shift, r) for r in records]


def idle_by_span(gaps, placed) -> Dict[str, float]:
    """Seconds of the idle gaps (start, end) by what the host had open: an
    open `gc.full` first, else the most recently opened span still open on
    any thread, else `none`. `placed`: (start, end, record) on the gaps'
    clock."""
    events = []
    for i, (s, e, _) in enumerate(placed):
        events.append((s, 1, i))
        events.append((e, 0, i))
    events.sort()
    open_heap: List[tuple] = []   # (-start, i) of open spans other than gc.full
    closed = set()
    gc_open = 0
    out: Dict[str, float] = defaultdict(float)

    def apply(kind, i):
        nonlocal gc_open
        is_gc = placed[i][2].name == "gc.full"
        if kind == 1:
            if is_gc:
                gc_open += 1
            else:
                heapq.heappush(open_heap, (-placed[i][0], i))
        elif is_gc:
            gc_open -= 1
        else:
            closed.add(i)

    def label():
        if gc_open > 0:
            return "gc.full"
        while open_heap and open_heap[0][1] in closed:
            closed.discard(heapq.heappop(open_heap)[1])
        return placed[open_heap[0][1]][2].name if open_heap else "none"

    j = 0
    for g0, g1 in sorted(gaps):
        while j < len(events) and events[j][0] <= g0:
            apply(events[j][1], events[j][2])
            j += 1
        t = g0
        while j < len(events) and events[j][0] < g1:
            out[label()] += events[j][0] - t
            t = events[j][0]
            apply(events[j][1], events[j][2])
            j += 1
        out[label()] += g1 - t
    return dict(out)


def span_stats(run, records) -> Dict[str, dict]:
    """Per span name, the spans wholly inside the window: count, mean ms,
    and their summed seconds."""
    by: Dict[str, List[int]] = defaultdict(list)
    lo, hi = _window_ns(run)
    for r in records:
        if lo <= r.t0 and r.t1 <= hi:
            by[r.name].append(r.t1 - r.t0)
    return {name: {"count": len(d), "mean_ms": sum(d) / len(d) / 1e6, "sum_s": sum(d) * NS}
            for name, d in sorted(by.items())}


def device_work_per_call(run) -> dict:
    """Device operations and copies (`Memcpy`) that started in the window,
    over the tier calls that started in it (only the device's work there
    comes from those calls)."""
    lo, hi = run.trace.window
    started = [name for s, _, name in run.trace.device if lo <= s < hi]
    n = len(run.calls_in_window())
    copies = sum(name.startswith("Memcpy") for name in started)
    return {"calls": n, "ops_per_call": len(started) / n if n else None,
            "copies_per_call": copies / n if n else None}


def span_pair_ns(pairs: int = 100_000) -> Optional[float]:
    """Host nanoseconds of one `with span(...)` on a private recorder."""
    from codegraph_tpu_torch.utils import perfmon

    if not hasattr(perfmon, "Recorder"):
        return None
    rec = perfmon.Recorder()
    rec.enable(True)
    try:
        t0 = time.perf_counter_ns()
        for _ in range(pairs):
            with rec.span("cost"):
                pass
        return (time.perf_counter_ns() - t0) / pairs
    finally:
        rec.enable(False)


def report(run) -> dict:
    """What the traced `run` shows by span (see the module docstring)."""
    out = {"device_work": device_work_per_call(run) if run.trace else None}
    records = window_records(run)
    if records is None:
        out["spans"] = None
        return out
    out["spans"] = span_stats(run, records)
    if run.trace is not None:
        idle = idle_by_span(run.trace.idle_gaps(), on_trace_clock(run, records))
        out["idle_s"] = sum(idle.values())
        out["idle_by_span"] = dict(sorted(idle.items(), key=lambda kv: -kv[1]))
    out["queue_wait_ms"] = queue_wait_ms(run)
    out["span_pair_ns"] = span_pair_ns()
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="portbench/spans.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    p.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)

    from portbench import harness

    t0 = time.perf_counter()
    cell = harness.resolve(args.workload)
    why = harness.card_count_error(cell.chips)
    if why:
        print(f"spans: {why}", file=sys.stderr)
        return 2
    if not args.recorder:
        from codegraph_tpu_torch.utils import perfmon

        if hasattr(perfmon, "enable"):
            perfmon.enable(False)
    runs = []
    reader = harness.metric_reader

    def keeping_the_run(name):
        read = reader(name)

        def kept(run):
            if not runs:
                runs.append(run)
            return read(run)
        return kept

    harness.metric_reader = keeping_the_run
    try:
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0=t0)
    finally:
        harness.metric_reader = reader
    line = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
            "recorder": args.recorder, "correct": result["correct"],
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "device": result["device"], "window_stats": result["window_stats"]}
    if args.trace and runs:
        line["breakdown"] = result.get("breakdown")
        line.update(report(runs[0]))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main(sys.argv[1:]))

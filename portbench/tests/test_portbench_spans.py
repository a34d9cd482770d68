"""The `program_span` readers and `portbench/spans.py`: each reader on a
traced tiny cell on the CPU, read against the program's own spans; None
without the recorder or when the ring lost part of the window; and the
attribution of the device's idle time on a synthetic trace."""

import json
from types import SimpleNamespace

import pytest

from portbench import harness, spans
from portbench.harness import PKG_DIR, ROOT
from portbench.tests.tiny import tiny_cell
from portbench.trace import Trace

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: the metrics read from the program's own spans (flush_ms.c256, labelled
#: program_span, reads the benchmark's proxy)
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if "portbench.spans" in (PKG_DIR / "metrics" / f"{m['name']}.py").read_text()]
PAIRS = [(m["name"], cell) for m in SPAN_METRICS for cell in m["workloads"]]
NS = 1_000_000_000


class CollectingIndex:
    """The tier, with a full collection on every fourth search, so that the
    window holds `gc.full` spans."""

    def __init__(self, index):
        self.index, self.calls = index, 0

    def search(self, queries, k):
        import gc

        self.calls += 1
        if self.calls % 4 == 0:
            gc.collect()
        return self.index.search(queries, k)


@pytest.fixture(scope="module")
def traced():
    """cell -> (result, run) of one traced tiny run on the CPU, made once."""
    made = {}

    def get(cell):
        if cell not in made:
            runs, reader = [], harness.metric_reader

            def keeping(name):
                read = reader(name)
                return lambda run: (runs.append(run), read(run))[1]

            harness.metric_reader = keeping
            try:
                result = harness.run_cell(tiny_cell(cell, clients=32), seed=2**31 + 21,
                                          seconds=0.5, trace=True, device="cpu",
                                          wrap=CollectingIndex)
            finally:
                harness.metric_reader = reader
            assert result["correct"], result["checks"]
            made[cell] = (result, runs[0])
        return made[cell]

    return get


def _mean_ms(run, records, name):
    got = spans.inside(run, records, name)
    return sum(r.t1 - r.t0 for r in got) / len(got) / 1e6


@pytest.mark.parametrize("metric,cell", PAIRS, ids=[f"{m}@{c}" for m, c in PAIRS])
def test_reader_reads_the_programs_spans(traced, metric, cell):
    result, run = traced(cell)
    value = result["metrics"][metric]["value"]
    records = spans.window_records(run)
    assert records and value > 0
    if metric.startswith("queue_wait_ms"):
        collects = spans.inside(run, records, "service.collect")
        assert value == pytest.approx(sum(r.m for r in collects) / sum(r.n for r in collects) / 1e3)
        # a query waits in the queue for less than its whole answer
        lat = run.outcome.latencies_in_window()
        assert value < 1e3 * lat.mean()
    elif metric.startswith("fanout_ms"):
        assert value == pytest.approx(_mean_ms(run, records, "service.fanout"))
        assert value < _mean_ms(run, records, "service.flush")
    elif metric.startswith("gc_pause_pct"):
        lo, hi = run.outcome.t_start * NS, run.outcome.t_end * NS
        full = [r for r in records if r.name == "gc.full"]
        assert full
        paused = sum(min(r.t1, hi) - max(r.t0, lo) for r in full)
        assert value == pytest.approx(100 * paused / (hi - lo), rel=1e-6)
    else:
        assert metric.startswith("index_launch_ms")
        searches = spans.inside(run, records, "index.search")
        assert 0 < value < _mean_ms(run, records, "index.search")
        calls = run.calls_in_window()
        assert abs(len(searches) - len(calls)) <= 2


@pytest.mark.parametrize("metric", sorted({m["name"] for m in SPAN_METRICS}))
def test_reader_reads_none_without_a_whole_window(traced, metric, monkeypatch):
    from codegraph_tpu_torch.utils import perfmon

    cell = next(m for m in SPAN_METRICS if m["name"] == metric)["workloads"][0]
    _, run = traced(cell)
    read = harness.metric_reader(metric)
    assert read(run) is not None

    def lost(t0, t1):
        return perfmon.Snapshot(records=[], dropped=1, complete=False)

    monkeypatch.setattr(perfmon, "snapshot", lost)
    assert read(run) is None
    monkeypatch.delattr(perfmon, "snapshot")  # a program without the recorder
    assert read(run) is None


def _rec(name, i):
    return SimpleNamespace(name=name, id=i)


def test_idle_time_goes_to_gc_then_the_newest_open_span():
    placed = [
        (0.0, 10.0, _rec("service.flush", 0)),      # thread 1
        (1.0, 4.0, _rec("index.search", 1)),        # thread 1, inside the flush
        (1.5, 3.0, _rec("index.scan", 2)),          # a tier child
        (6.0, 8.0, _rec("service.linger", 3)),      # thread 2, opened later
        (7.0, 7.5, _rec("gc.full", 4)),             # older spans open under it
        (12.0, 13.0, _rec("service.collect", 5)),
    ]
    gaps = [(2.0, 2.5),     # under the tier child
            (3.5, 5.0),     # index.search, then the flush once the search closes
            (5.5, 9.0),     # flush, linger on another thread, gc.full, linger, flush
            (10.5, 11.5)]   # no span
    idle = spans.idle_by_span(gaps, placed)
    expect = {"index.scan": 0.5, "index.search": 0.5, "service.flush": 1.0 + 0.5 + 1.0,
              "service.linger": 1.5, "gc.full": 0.5, "none": 1.0}
    assert idle.keys() == expect.keys()
    for label, seconds in expect.items():
        assert idle[label] == pytest.approx(seconds), label


def test_a_synthetic_trace_is_attributed_on_the_shifted_clock():
    """Records on the host clock placed on the trace's clock by the window
    span's shift, then attributed over the trace's idle gaps."""
    t_start = 100.0                                   # host clock of the window
    trace = Trace(window=(5.0, 6.0),                  # trace clock
                  device=[(5.0, 5.2, "k"), (5.5, 5.6, "k"), (5.9, 6.0, "k")], calls=[])
    run = SimpleNamespace(trace=trace, outcome=SimpleNamespace(t_start=t_start, t_end=101.0))
    host = [("index.search", 100.1, 100.45, 0), ("index.copy_back", 100.3, 100.45, 1),
            ("gc.full", 100.62, 100.7, 2)]
    records = [SimpleNamespace(name=n, t0=int(a * NS), t1=int(b * NS), id=i)
               for n, a, b, i in host]
    placed = spans.on_trace_clock(run, records)
    assert placed[0][0] == pytest.approx(5.1) and placed[2][1] == pytest.approx(5.7)
    idle = spans.idle_by_span(trace.idle_gaps(), placed)
    # gaps 5.2-5.5 (the search to 5.3, its copy-back to 5.45) and 5.6-5.9
    # (a full collection 5.62-5.7); the rest under no span
    assert sum(idle.values()) == pytest.approx(0.6)
    assert idle["index.search"] == pytest.approx(0.1)
    assert idle["index.copy_back"] == pytest.approx(0.15)
    assert idle["gc.full"] == pytest.approx(0.08)
    assert idle["none"] == pytest.approx(0.6 - 0.1 - 0.15 - 0.08)

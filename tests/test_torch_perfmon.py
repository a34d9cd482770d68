"""The port's span recorder (`utils/perfmon.py`) and the spans it records
in `QueryService` and the flat and int8 tiers, on the CPU: nesting, one
request id across threads, concurrent writers, the ring's overwrite
count, switching off, the gc hook, the service's payloads against the
submit and take stamps, the tiers' phase order, `PerformanceMonitor`'s
timer and the `/metrics` source over the recorder."""

import gc
import sys
import threading
import time

import numpy as np
import pytest

from codegraph_tpu_torch.index.flat import FlatIndex
from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex
from codegraph_tpu_torch.search.service import QueryService
from codegraph_tpu_torch.utils import metrics, perfmon
from codegraph_tpu_torch.utils.perfmon import OFF, PerformanceMonitor, Recorder

TIER_CHILDREN = {
    FlatIndex: ["index.upload", "index.prepare", "index.scan", "index.copy_back", "index.post"],
    Int8FlatIndex: ["index.upload", "index.prepare", "index.scan", "index.rescore",
                    "index.copy_back", "index.post"],
}


@pytest.fixture
def rec():
    r = Recorder(1 << 12)
    r.enable(True)
    try:
        yield r
    finally:
        r.enable(False)


def _all(r):
    return r.snapshot(0, 2**62).records


def _global_since(t0):
    return perfmon.snapshot(t0, time.perf_counter_ns()).records


def test_the_process_recorder_is_on_by_default():
    assert perfmon.RECORDER.on
    assert perfmon.RECORDER._on_gc in gc.callbacks
    assert perfmon.RECORDER.capacity == perfmon.CAPACITY == 1 << 17


def test_nesting_parents_and_request_ids(rec):
    with rec.span("a", n=3) as a:
        with rec.span("b") as b:
            b.m = 7
            with rec.span("c", rid=99):
                pass
        with rec.span("d"):
            pass
    with rec.span("e"):
        pass
    by = {r.name: r for r in _all(rec)}
    assert set(by) == {"a", "b", "c", "d", "e"}
    assert by["a"].parent == -1 and by["e"].parent == -1
    assert by["b"].parent == by["d"].parent == a.id and by["c"].parent == b.id
    assert by["a"].rid == by["b"].rid == by["d"].rid and by["c"].rid == 99
    assert by["e"].rid != by["a"].rid
    assert (by["a"].n, by["b"].m) == (3, 7)
    assert by["a"].t0 <= by["b"].t0 <= by["c"].t0 <= by["c"].t1 <= by["b"].t1 <= by["d"].t0
    assert by["d"].t1 <= by["a"].t1 <= by["e"].t0
    assert {r.thread for r in by.values()} == {threading.get_ident()}
    assert rec._stack() == []


def test_one_request_id_across_threads(rec):
    """A span opened on one thread, made current on another and ended
    there: the other thread's spans nest under it and share its id."""
    rid = rec.new_request()
    with rec.span("collect", rid=rid):
        pass
    flush = rec.begin("flush", rid=rid)

    def worker():
        with rec.current(flush):
            with rec.span("child"):
                with rec.span("grandchild"):
                    pass
        rec.end(flush, n=5)

    t = threading.Thread(target=worker)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    by = {r.name: r for r in _all(rec)}
    assert {r.rid for r in by.values()} == {rid}
    assert by["child"].parent == flush.id == by["flush"].id
    assert by["grandchild"].parent == by["child"].id
    assert by["flush"].thread == by["collect"].thread == threading.get_ident()
    assert by["child"].thread == t.ident != by["flush"].thread
    assert by["flush"].n == 5 and by["flush"].t0 <= by["child"].t0 <= by["flush"].t1


def test_eight_threads_record_at_once():
    """No record lost or torn with eight writers and a short switch interval."""
    r = Recorder(1 << 15)
    r.enable(True)
    per_thread, threads = 2000, 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    # all eight alive at once, from the first record to the last
    barrier = threading.Barrier(threads, timeout=60)
    try:
        def writer(w):
            barrier.wait()
            for j in range(per_thread):
                with r.span(f"w{w}", n=w, m=j):
                    with r.span(f"w{w}.in", n=w, m=j):
                        pass
            barrier.wait()
        ts = [threading.Thread(target=writer, args=(w,)) for w in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        r.enable(False)
    records = _all(r)
    assert len(records) == 2 * per_thread * threads and r.dropped() == 0
    assert len({x.id for x in records}) == len(records)
    by_id = {x.id: x for x in records}
    idents = {}
    for x in records:
        w = int(x.name[1:].split(".")[0])
        assert x.n == w and x.t0 <= x.t1
        assert idents.setdefault(w, x.thread) == x.thread
        if x.name.endswith(".in"):
            outer = by_id[x.parent]
            assert outer.name == f"w{w}" and outer.m == x.m and outer.rid == x.rid
    assert len(set(idents.values())) == threads
    for w in range(threads):
        assert sorted(x.m for x in records if x.name == f"w{w}") == list(range(per_thread))
    totals = r.totals()
    assert all(totals[f"w{w}"][0] == per_thread for w in range(threads))


def test_ring_overwrite_is_counted_as_dropped():
    r = Recorder(16)
    r.enable(True)
    try:
        ends = []
        for j in range(40):
            with r.span("x", m=j):
                pass
            ends.append(time.perf_counter_ns())
    finally:
        r.enable(False)
    assert r.dropped() == 24
    snap = r.snapshot(0, 2**62)
    assert [x.m for x in snap.records] == list(range(24, 40))
    assert snap.dropped == 24 and not snap.complete
    # a window that starts after the last lost record ended lost nothing
    assert r.snapshot(ends[23] + 1, 2**62).complete
    assert not r.snapshot(ends[22], 2**62).complete
    assert r.totals()["x"][0] == 40


def test_disabled_records_nothing_and_removes_the_gc_hook(rec):
    assert rec._on_gc in gc.callbacks
    rec.enable(False)
    assert rec._on_gc not in gc.callbacks
    with rec.span("x") as s:
        s.n = 4
    rec.end(rec.begin("y"))
    with rec.current(rec.begin("z")):
        pass
    gc.collect()
    assert _all(rec) == [] and rec.gc_collections == [0, 0, 0] and rec.totals() == {}
    assert rec.begin("y") is OFF


def test_a_forced_collection_records_gc_full(rec):
    garbage = []
    garbage.append(garbage)
    del garbage
    t0 = time.perf_counter_ns()
    gc.collect()
    full = [x for x in _all(rec) if x.name == "gc.full"]
    assert len(full) == 1 and full[0].t0 >= t0 and full[0].n >= 1
    assert rec.gc_collections[2] == 1
    assert rec.totals()["gc.full"][0] == 1


def _eye_index(cls=FlatIndex, d=16):
    index = cls(d, device="cpu")
    index.add(np.eye(d, dtype=np.float32))
    return index


def test_service_flush_spans_share_one_request_id():
    """One flush of three queries through two flush workers: collect,
    assemble, the tier's spans and fanout under one request id; the rows,
    the padding and the queue-wait sum match the submit and take stamps."""
    index = _eye_index()
    svc = QueryService(index, k=2, max_batch=4, max_wait_ms=200.0, workers=2, pad_buckets=(4,))
    t_start = time.perf_counter_ns()
    try:
        stamps, futs = [], []
        for i in range(3):
            before = time.perf_counter_ns()
            futs.append(svc.submit(np.eye(16, dtype=np.float32)[i]))
            stamps.append((before, time.perf_counter_ns()))
        answers = [f.result(timeout=30) for f in futs]
    finally:
        svc.close()
    assert [int(a[1][0]) for a in answers] == [0, 1, 2]
    records = _global_since(t_start)
    collect = next(x for x in records if x.name == "service.collect" and x.n == 3)
    mine = {x.name: x for x in records if x.rid == collect.rid}
    assert set(mine) == {"service.linger", "service.collect", "service.flush",
                         "service.assemble", "service.fanout", "index.search",
                         *TIER_CHILDREN[FlatIndex]}
    flush, search = mine["service.flush"], mine["index.search"]
    collector = collect.thread
    assert mine["service.linger"].thread == flush.thread == collector
    assert mine["service.linger"].t1 <= collect.t0 <= collect.t1 <= flush.t0
    for name in ("service.assemble", "index.search", "service.fanout"):
        assert mine[name].parent == flush.id and mine[name].thread != collector
        assert flush.t0 <= mine[name].t0 <= mine[name].t1 <= flush.t1
    assert mine["service.assemble"].t1 <= search.t0 <= search.t1 <= mine["service.fanout"].t0
    for name in TIER_CHILDREN[FlatIndex]:
        assert mine[name].parent == search.id
    assert (flush.n, flush.m, search.n, mine["service.fanout"].n) == (3, 1, 4, 3)
    # m: the summed wait from each submit to the take, inside the collect span
    low = sum(collect.t0 - after for _, after in stamps) // 1000
    high = sum(collect.t1 - before for before, _ in stamps) // 1000
    assert low - 1 <= collect.m <= high + 1


class _SlowIndex:
    def __init__(self, index):
        self.index = index

    def search(self, queries, k):
        time.sleep(0.05)
        return self.index.search(queries, k)


def test_service_queue_timeout_reads_the_recorder_clock():
    svc = QueryService(_SlowIndex(_eye_index()), k=2, max_batch=1, max_wait_ms=0.0,
                       queue_timeout_ms=10.0)
    try:
        futs = [svc.submit(np.eye(16, dtype=np.float32)[i]) for i in range(3)]
        assert int(futs[0].result(timeout=30)[1][0]) == 0
        for f in futs[1:]:
            with pytest.raises(TimeoutError):
                f.result(timeout=30)
    finally:
        svc.close()
    assert svc.stats.expired == 2


@pytest.mark.parametrize("cls", [FlatIndex, Int8FlatIndex], ids=lambda c: c.__name__)
@pytest.mark.parametrize("batch", [1, 40])
def test_tier_spans_in_order(cls, batch):
    index = _eye_index(cls, d=48)
    queries = np.random.default_rng(batch).standard_normal((batch, 48)).astype(np.float32)
    t_start = time.perf_counter_ns()
    index.search(queries, 5)
    index.search(queries, 5)
    records = [x for x in _global_since(t_start) if x.thread == threading.get_ident()]
    searches = [x for x in records if x.name == "index.search"]
    assert len(searches) == 2 and searches[0].rid != searches[1].rid
    for top in searches:
        assert top.n == batch and top.parent == -1
        children = [x for x in records if x.parent == top.id]
        assert [x.name for x in children] == TIER_CHILDREN[cls]
        assert all(x.rid == top.rid for x in children)
        assert top.t0 <= children[0].t0 and children[-1].t1 <= top.t1
        for a, b in zip(children, children[1:]):
            assert a.t1 <= b.t0
        scan = next(x for x in children if x.name == "index.scan")
        copy_back = next(x for x in children if x.name == "index.copy_back")
        assert scan.t1 <= copy_back.t0


def test_performance_monitor_timer_records_a_span():
    mon = PerformanceMonitor()
    t_start = time.perf_counter_ns()
    for _ in range(3):
        with mon.timer("vector_search_ms", "hybrid.vector_search"):
            time.sleep(0.001)
    mon.record("vector_search_ms", 500.0)  # past the 200 ms baseline: only recorded
    report = mon.report()["vector_search_ms"]
    assert report["n"] == 4 and report["meets_target"] is False
    spans = [x for x in _global_since(t_start) if x.name == "hybrid.vector_search"]
    assert len(spans) == 3 and all(x.t1 - x.t0 >= 1_000_000 for x in spans)
    assert not hasattr(mon, "alerts")


def test_span_source_renders_totals(rec):
    for name in ("a", "a", "b"):
        with rec.span(name):
            pass
    gc.collect()
    reg = metrics.MetricsRegistry()
    reg.register("spans", metrics.make_span_source(rec))
    text = reg.render()
    lines = text.splitlines()
    assert 'codegraph_span_count_total{span="a"} 2' in lines
    assert 'codegraph_span_count_total{span="b"} 1' in lines
    assert 'codegraph_span_count_total{span="gc.full"} 1' in lines
    assert "codegraph_gc_full_total 1" in lines
    assert 'codegraph_gc_collections_total{generation="2"} 1' in lines
    assert "codegraph_spans_dropped_total 0" in lines
    for family in ("span_count_total", "span_seconds_total", "gc_full_total",
                   "gc_full_seconds_total", "gc_collections_total", "spans_dropped_total"):
        assert f"# TYPE codegraph_{family} counter" in lines
    seconds = {ln.split("} ")[0]: float(ln.split()[-1]) for ln in lines
               if ln.startswith("codegraph_span_seconds_total")}
    assert seconds['codegraph_span_seconds_total{span="a"'] > 0
    full = float(next(ln.split()[-1] for ln in lines if ln.startswith("codegraph_gc_full_seconds")))
    assert full == pytest.approx(rec.totals()["gc.full"][1])

"""The port's watch daemon and its helpers (host copies: `daemon.py`,
`mcp/process.py`, `utils/heartbeat.py`, `utils/circuit.py`,
`graph/propagation.py`, `mcp/coordination.py`, `mcp/prompts.py`,
`mcp/tiers.py`, `indexer/estimation.py`), held to the JAX package on the
CPU.

Every comparison is exact: the same project, batches, clock readings and
agent scripts give the same metrics, states, plans and results. The one
process test spawns the port's daemon with `--device cpu` and checks that
the child got that device, indexed the project and stopped on request.
"""

import dataclasses
import os
import shutil
import sys
import threading
import time

import pytest
import torch

from codegraph_tpu import daemon as jdaemon
from codegraph_tpu.core.config import CodeGraphConfig as JConfig
from codegraph_tpu.graph import propagation as jprop
from codegraph_tpu.indexer import estimation as jest
from codegraph_tpu.indexer.indexer import ProjectIndexer as JIndexer
from codegraph_tpu.mcp import coordination as jco
from codegraph_tpu.mcp import process as jproc
from codegraph_tpu.mcp import prompts as jpr
from codegraph_tpu.mcp import tiers as jti
from codegraph_tpu.parser.watcher import BatchedChanges as JBatch
from codegraph_tpu.utils import circuit as jcirc
from codegraph_tpu.utils import heartbeat as jhb
from codegraph_tpu_torch import daemon as tdaemon
from codegraph_tpu_torch.core.config import CodeGraphConfig as TConfig
from codegraph_tpu_torch.graph import propagation as tprop
from codegraph_tpu_torch.indexer import estimation as test_
from codegraph_tpu_torch.indexer.indexer import ProjectIndexer as TIndexer
from codegraph_tpu_torch.mcp import coordination as tco
from codegraph_tpu_torch.mcp import process as tproc
from codegraph_tpu_torch.mcp import prompts as tpr
from codegraph_tpu_torch.mcp import tiers as tti
from codegraph_tpu_torch.parser.watcher import BatchedChanges as TBatch
from codegraph_tpu_torch.utils import circuit as tcirc
from codegraph_tpu_torch.utils import heartbeat as thb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(cls, proj, data):
    cfg = cls()
    cfg.embedding.provider = "hash"
    cfg.embedding.fallbacks = []
    cfg.embedding.dimension = 64
    cfg.project_root = str(proj)
    cfg.data_dir = str(data)
    return cfg


def _project(tmp_path, sub="graph"):
    proj = tmp_path / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", sub), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))
    return proj


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_process_batch_equal(tmp_path):
    """The same created / modified / deleted batches through each package's
    WatchDaemon.process_batch: the same metrics, graph and impact plans."""
    proj = _project(tmp_path)
    sides = []
    for cls, daemon_mod, indexer_cls, kw in ((JConfig, jdaemon, JIndexer, {}),
                                             (TConfig, tdaemon, TIndexer, {"device": "cpu"})):
        cfg = _cfg(cls, proj, tmp_path / f"data_{cls.__module__.split('.')[0]}")
        daemon = daemon_mod.WatchDaemon(cfg, str(proj), **kw)
        indexer = indexer_cls(cfg, **kw)
        indexer.index_project(str(proj))
        sides.append((daemon, indexer))
    new = proj / "watch_new.py"
    new.write_text("from store import GraphStore\n\ndef build_more(s):\n    return GraphStore()\n")
    csr = str(proj / "csr.py")
    with open(csr, "a") as f:
        f.write("\n\ndef appended_helper():\n    return build_csr\n")
    batches = [(JBatch(created=[str(new)], modified=[csr]), TBatch(created=[str(new)], modified=[csr])),
               (JBatch(deleted=[str(new)]), TBatch(deleted=[str(new)]))]
    for i, (jb, tb) in enumerate(batches):
        if i == 1:
            new.unlink()
        for (daemon, indexer), batch in zip(sides, (jb, tb)):
            daemon.process_batch(indexer, batch)
        (jd, ji), (td, ti) = sides
        jm, tm = jd.metrics.to_dict(), td.metrics.to_dict()
        for m in (jm, tm):
            m.pop("started_at"), m.pop("uptime_s")
        assert jm == tm
        assert sorted(n.name for n in ji.store.nodes.values()) == \
            sorted(n.name for n in ti.store.nodes.values())
    assert tm["batches"] == 2 and tm["files_indexed"] == 2 and tm["files_deleted"] == 1
    assert tm["impacted_nodes"] > 0


def test_propagation_plans_equal(tmp_path):
    proj = _project(tmp_path)
    cfg = _cfg(JConfig, proj, tmp_path / "data")
    jidx = JIndexer(cfg)
    jidx.index_project(str(proj))
    jidx.save()
    tidx = TIndexer(_cfg(TConfig, proj, tmp_path / "data"), device="cpu")
    tidx.load(str(tmp_path / "data"))
    files = sorted(jidx.store.file_nodes)
    cases = [files[:1], files[1:3], [str(proj / "missing.py")], files]
    impacted = 0
    for changed in cases:
        for depth, decay in ((3, 0.5), (1, 0.25)):
            a = jprop.PropagationManager(jidx.store, decay=decay, max_depth=depth).plan_for_files(changed)
            b = tprop.PropagationManager(tidx.store, decay=decay, max_depth=depth).plan_for_files(changed)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.total_impacted == b.total_impacted
            impacted += b.total_impacted
    assert impacted > 0


@pytest.mark.parametrize("events", [
    "FFFFF.s.F.ss",            # trips at the threshold, waits out its cooldown, probes
    "FFFFF.....F..F...s",      # a failed probe doubles the backoff
    "FsFsFFFFFF",              # successes reset the count
    "FFFFFFFFFF...........",   # backoff is capped
])
def test_circuit_breaker_equal(events):
    """F = record_failure, s = record_success, . = one second passes; after
    each step both breakers admit (or not) and report the same state."""
    out = []
    for mod in (jcirc, tcirc):
        clock = Clock()
        br = mod.CircuitBreaker(failure_threshold=5, backoff_base_s=2.0, backoff_max_s=5.0,
                                clock=clock)
        trace = []
        for ev in events:
            if ev == "F":
                br.record_failure()
            elif ev == "s":
                br.record_success()
            else:
                clock.t += 1.0
            trace.append((br.state.value, br.should_allow_request(), br.should_allow_request(),
                          br.failures, br.consecutive_opens, br.cooldown_remaining_s))
        out.append(trace)
    assert out[0] == out[1]
    assert any(s == "open" for s, *_ in out[1])


def test_heartbeat_equal():
    out = []
    for mod in (jhb, thb):
        clock = Clock()
        hb = mod.HeartbeatMonitor(interval_s=2.0, max_missed=3, clock=clock)
        trace = []
        for step in (0.5, 1.6, 2.0, 2.0, 3.0, "pong", 1.9, 2.2):
            if step == "pong":
                hb.pong()
            else:
                clock.t += step
            trace.append((hb.missed, hb.state.value))
        out.append(trace)
    assert out[0] == out[1]
    assert [s for _, s in out[1]] == ["healthy", "degraded", "degraded", "failed", "failed",
                                      "healthy", "healthy", "degraded"]


def test_heartbeat_thread_calls_on_failed():
    fired = threading.Event()
    hb = thb.HeartbeatMonitor(interval_s=0.02, max_missed=1, on_failed=fired.set)
    hb.start()
    try:
        assert fired.wait(5)
    finally:
        hb.stop()
    assert not hb._thread.is_alive()


def test_watch_daemon_circuit_gating_equal(tmp_path):
    out = []
    for cls, mod in ((JConfig, jdaemon), (TConfig, tdaemon)):
        cfg = _cfg(cls, tmp_path, tmp_path / "data")
        cfg.daemon.failure_threshold = 1
        d = mod.WatchDaemon(cfg, str(tmp_path))
        d.breaker.record_failure()
        out.append((d.breaker.state.value, d.breaker.should_allow_request(),
                    d.heartbeat.interval_s, d.heartbeat.max_missed))
    assert out[0] == out[1] and out[1][:2] == ("open", False)


def test_watch_daemon_run_loop(tmp_path, monkeypatch):
    """WatchDaemon.run on the CPU: with no snapshot it indexes and saves;
    a new file is reindexed; a failing batch opens the circuit and the next
    batch is dropped; stop() ends the loop."""
    proj = _project(tmp_path, "utils")
    cfg = _cfg(TConfig, proj, tmp_path / "data")
    cfg.indexing.watch_debounce_ms = 30
    cfg.daemon.batch_timeout_ms = 30
    cfg.daemon.failure_threshold = 1
    cfg.daemon.backoff_base_s = 60.0
    daemon = tdaemon.WatchDaemon(cfg, str(proj), device="cpu")
    thread = threading.Thread(target=daemon.run, daemon=True)
    thread.start()

    def wait(cond, what, timeout=60):
        deadline = time.time() + timeout
        while not cond():
            assert thread.is_alive() and time.time() < deadline, what
            time.sleep(0.05)

    try:
        wait(lambda: (tmp_path / "data" / "store_meta.json").exists(), "first index")
        # the watcher takes its baseline before the heartbeat starts: a file
        # written earlier would be part of it, not a change
        wait(lambda: daemon.heartbeat._thread is not None, "the watch loop")
        (proj / "daemon_new.py").write_text("def daemon_added():\n    return 1\n")
        wait(lambda: daemon.metrics.files_indexed >= 1, "reindex of a new file")
        assert daemon.metrics.failures == 0 and daemon.breaker.state.value == "closed"

        def fail(indexer, batch):
            raise RuntimeError("batch failed")

        monkeypatch.setattr(daemon, "process_batch", fail)
        (proj / "daemon_bad.py").write_text("def bad():\n    return 2\n")
        wait(lambda: daemon.metrics.failures == 1, "a failing batch")
        assert daemon.breaker.state.value == "open"
        (proj / "daemon_dropped.py").write_text("def dropped():\n    return 3\n")
        time.sleep(0.5)
        assert daemon.metrics.failures == 1  # dropped while the circuit is open
    finally:
        daemon.stop()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_daemon_manager_child_on_cpu(tmp_path, monkeypatch):
    """DaemonManager.start spawns `python -m codegraph_tpu_torch.daemon ROOT
    --device cpu`; the child indexes the project on the CPU; status and stop
    see it, and a second start reports it running."""
    proj = _project(tmp_path, "utils")
    data = tmp_path / "data"
    monkeypatch.setenv("CODEGRAPH_EMBEDDING_PROVIDER", "hash")
    monkeypatch.setenv("CODEGRAPH_EMBEDDING_DIMENSION", "64")
    monkeypatch.setenv("CODEGRAPH_DATA_DIR", str(data))
    monkeypatch.setenv("CODEGRAPH_CONFIG_DIR", str(tmp_path / "config"))
    monkeypatch.setenv("PYTHONPATH", REPO)
    cfg = _cfg(TConfig, proj, data)
    mgr = tdaemon.DaemonManager(cfg, "cpu")
    assert mgr.status() == {"running": False, "pid": None}
    started = mgr.start(str(proj))
    pid = started["pid"]
    try:
        assert started["status"] == "started"
        argv, deadline = [], time.time() + 30
        while not argv and time.time() < deadline:  # empty until the child has exec'd
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().split(b"\0")[:-1]
            time.sleep(0.05)
        assert argv[1:] == [b"-m", b"codegraph_tpu_torch.daemon", str(proj).encode(),
                            b"--device", b"cpu"]
        assert mgr.status() == {"running": True, "pid": pid}
        assert mgr.start(str(proj)) == {"status": "already_running", "pid": pid}
        deadline = time.time() + 120
        while not (data / "store_meta.json").exists():
            assert tproc.is_alive(pid) and time.time() < deadline, "the child did not index"
            time.sleep(0.2)
    finally:
        stopped = mgr.stop()
    assert stopped == {"status": "stopped", "pid": pid}
    assert mgr.status() == {"running": False, "pid": None}
    assert mgr.stop() == {"status": "not_running"}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present: cuda would run")
def test_daemon_manager_refuses_cuda_without_gpu(tmp_path):
    """The default device is "cuda": with no GPU, start raises before it
    spawns a child that would fail unseen."""
    mgr = tdaemon.DaemonManager(_cfg(TConfig, tmp_path, tmp_path / "d"))
    with pytest.raises(RuntimeError, match="cuda"):
        mgr.start(str(tmp_path))
    assert mgr.status() == {"running": False, "pid": None}
    assert not os.path.exists(tproc.pid_path(str(tmp_path / "d")))


def test_daemon_manager_not_running_equal(tmp_path):
    mgr_j = jdaemon.DaemonManager(_cfg(JConfig, tmp_path, tmp_path / "d"))
    mgr_t = tdaemon.DaemonManager(_cfg(TConfig, tmp_path, tmp_path / "d"), "cpu")
    assert mgr_j.status() == mgr_t.status() == {"running": False, "pid": None}
    assert mgr_j.stop() == mgr_t.stop() == {"status": "not_running"}


def test_pid_files_equal(tmp_path, monkeypatch):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(jdir)
    os.makedirs(tdir)
    assert os.path.basename(jproc.write_pid(jdir)) == \
        os.path.basename(tproc.write_pid(tdir)) == "daemon.pid"
    assert jproc.read_pid(jdir) == tproc.read_pid(tdir) == os.getpid()
    # a stale pid file (no such process) is cleaned up
    for mod, d in ((jproc, jdir), (tproc, tdir)):
        mod.write_pid(d, 2 ** 22 + 12345)
        assert mod.read_pid(d) is None and not os.path.exists(mod.pid_path(d))
        mod.clear_pid(d)
    for mod in (jproc, tproc):
        def eperm(pid, sig):
            raise PermissionError
        monkeypatch.setattr(os, "kill", eperm)
        assert mod.is_alive(12345)  # exists, another user's
        def esrch(pid, sig):
            raise ProcessLookupError
        monkeypatch.setattr(os, "kill", esrch)
        assert not mod.is_alive(12345)


def test_daemon_main_takes_device(tmp_path, monkeypatch):
    seen = []

    class Fake:
        def __init__(self, cfg, root, device="cuda"):
            seen.append((root, device, cfg.project_root))

        def run(self):
            pass

        def stop(self):
            pass

    monkeypatch.setattr(tdaemon, "WatchDaemon", Fake)
    monkeypatch.setattr(sys, "argv", ["daemon", str(tmp_path), "--device", "cpu"])
    tdaemon._main()
    tdaemon._main([str(tmp_path)])
    assert seen == [(str(tmp_path), "cpu", str(tmp_path)), (str(tmp_path), "cuda", str(tmp_path))]


# -- coordination, prompts and estimation -------------------------------------


def _coordinate(mod):
    reg = mod.AgentRegistry()
    calls = {"flaky": 0}

    def flaky(desc):
        calls["flaky"] += 1
        if calls["flaky"] == 1:
            raise RuntimeError("transient")
        return f"flaky: {desc}"

    def down(desc):
        raise RuntimeError("down")

    reg.register("flaky", ["search"], flaky)
    reg.register("voter_a", ["vote", "search"], lambda d: "yes")
    reg.register("voter_b", ["vote"], lambda d: "yes")
    reg.register("voter_c", ["vote"], lambda d: "no")
    reg.register("bad", ["x"], down).breaker.failure_threshold = 2
    coord = mod.Coordinator(reg)
    P = mod.AggregationPolicy
    specs = [mod.TaskSpec("t1", "find it", ["search"], max_retries=1),
             mod.TaskSpec("t2", "vote", ["vote"], aggregation=P.ALL),
             mod.TaskSpec("t3", "vote", ["vote"], aggregation=P.MAJORITY),
             mod.TaskSpec("t4", "x", ["x"], max_retries=2),
             mod.TaskSpec("t5", "x", ["x"]),
             mod.TaskSpec("t6", "nobody", ["missing"])]
    out = []
    for spec in specs:
        results = coord.execute(spec)
        out.append(([(r.task_id, r.agent, r.ok, r.result, r.error) for r in results],
                    coord.aggregate(spec, results), [a.name for a in reg.candidates(spec)]))
    return out, reg.stats(), len(coord.history)


def test_coordination_equal():
    a, b = _coordinate(jco), _coordinate(tco)
    assert a == b
    results, stats, _ = b
    assert results[2][1] == "yes" and results[5][0][0][4] == "no capable agent available"
    assert stats["bad"]["circuit"] == "open" and stats["flaky"]["failed"] == 1


def test_estimate_equal(tmp_path):
    proj = _project(tmp_path)
    a = jest.RepositoryEstimator(_cfg(JConfig, proj, tmp_path / "d"))
    b = test_.RepositoryEstimator(_cfg(TConfig, proj, tmp_path / "d"), device="cpu")
    ea, eb = a.analyze(str(proj)).to_dict(), b.analyze(str(proj)).to_dict()
    assert ea.pop("parse_seconds") >= 0 and eb.pop("parse_seconds") >= 0
    assert ea == eb and eb["nodes"] > 0
    assert a.index_plan.to_dict() == b.index_plan.to_dict()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            test_.RepositoryEstimator(_cfg(TConfig, proj, tmp_path / "d"))


def test_tiers_and_prompts_equal():
    for window in (8_000, 30_000, 64_000, 128_000, 200_000, 500_000, 1_000_000):
        assert tti.ContextTier.from_context_window(window).value == \
            jti.ContextTier.from_context_window(window).value
    for tier in jti.ContextTier:
        assert vars(tti.tier_limits(tti.ContextTier(tier.value))) == vars(jti.tier_limits(tier))
        for at in jpr.AnalysisType:
            for query in ("", "where is the cache invalidated"):
                assert tpr.PromptSelector(tti.ContextTier(tier.value)).select(
                    tpr.AnalysisType(at.value), query) == jpr.PromptSelector(tier).select(at, query)
    assert {k: v.value for k, v in tpr.FOCUS_TO_ANALYSIS.items()} == \
        {k: v.value for k, v in jpr.FOCUS_TO_ANALYSIS.items()}

"""Copy of `codegraph_tpu/daemon.py` for the PyTorch port. The daemon takes
the device its indexer runs on ("cuda" unless "cpu" is passed): the manager
spawns `python -m codegraph_tpu_torch.daemon ROOT --device D`, so the child
runs on its parent's device (a CUDA device without a GPU raises in `start`,
before the spawn), and the child's `_main` has no platform set-up to apply
(the JAX package's `apply_platform_env`).

Watch daemon: background incremental re-indexing with a circuit breaker.

Reference: codegraph-mcp-daemon/src/daemon/ — WatchDaemon start/stop/
status (mod.rs:27-141), DaemonManager background process (manager.rs:78),
HealthMonitor circuit breaker gating batch processing (health.rs:78),
WatchSession batch loop (session.rs:88-93), PID files (pid.rs).
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict

from codegraph_tpu_torch.core.config import CodeGraphConfig
from codegraph_tpu_torch.mcp.process import clear_pid, is_alive, read_pid, write_pid
from codegraph_tpu_torch.parser.watcher import BatchedChanges, FileWatcher
from codegraph_tpu_torch.utils.circuit import CircuitBreaker
from codegraph_tpu_torch.utils.heartbeat import HeartbeatMonitor

logger = logging.getLogger("codegraph_tpu_torch.daemon")


@dataclass
class SessionMetrics:
    """Reference: SessionMetrics, session.rs:83."""

    batches: int = 0
    files_indexed: int = 0
    files_deleted: int = 0
    impacted_nodes: int = 0
    failures: int = 0
    started_at: float = field(default_factory=time.time)

    def to_dict(self) -> Dict:
        return {**self.__dict__, "uptime_s": round(time.time() - self.started_at, 1)}


class WatchDaemon:
    """In-process watch loop (run in the foreground or under the manager)."""

    def __init__(self, config: CodeGraphConfig, root: str, device="cuda"):
        self.config = config
        self.root = root
        self.device = device
        self.metrics = SessionMetrics()
        self.breaker = CircuitBreaker(
            failure_threshold=config.daemon.failure_threshold,
            backoff_base_s=config.daemon.backoff_base_s,
            backoff_max_s=config.daemon.backoff_max_s,
        )
        self.heartbeat = HeartbeatMonitor(
            interval_s=config.daemon.heartbeat_interval_s,
            max_missed=config.daemon.heartbeat_max_missed,
        )
        self._stop = threading.Event()

    def run(self) -> None:
        from codegraph_tpu_torch.indexer.indexer import ProjectIndexer

        self.config.project_root = self.root
        indexer = ProjectIndexer(self.config, device=self.device)
        data_dir = str(self.config.resolved_data_dir())
        if os.path.exists(os.path.join(data_dir, "store_meta.json")):
            indexer.load(data_dir)
        else:
            indexer.index_project(self.root)
            indexer.save(data_dir)

        watcher = FileWatcher(
            self.root,
            debounce_s=self.config.indexing.watch_debounce_ms / 1000.0,
            exclude_globs=self.config.indexing.exclude_globs,
        )
        self.heartbeat.start()
        logger.info("watch daemon running on %s", self.root)
        while not self._stop.is_set():
            self.heartbeat.pong()
            watcher.poll_once()
            # poll cadence: bounded by BOTH the debounce window and the
            # batch timeout (CODEGRAPH_DAEMON_BATCH_TIMEOUT_MS caps how
            # long a ready batch can sit before processing)
            self._stop.wait(
                min(self.config.indexing.watch_debounce_ms,
                    self.config.daemon.batch_timeout_ms) / 1000.0
            )
            batch = watcher.next_batch()
            if batch.empty:
                continue
            if not self.breaker.should_allow_request():
                logger.warning(
                    "circuit open (%.1fs cooldown); dropping batch",
                    self.breaker.cooldown_remaining_s,
                )
                continue
            try:
                self.process_batch(indexer, batch)
                indexer.save(data_dir)
                self.breaker.record_success()
            except Exception:
                logger.exception("batch failed")
                self.metrics.failures += 1
                self.breaker.record_failure()
        self.heartbeat.stop()

    def process_batch(self, indexer, batch: BatchedChanges) -> None:
        """session.rs:93 process_batch semantics + change-impact
        propagation: after reindexing, dependents of the changed files
        re-enrich (their reference counts / impact metadata shift even
        though their content didn't)."""
        from codegraph_tpu_torch.graph.propagation import PropagationManager

        self.metrics.batches += 1
        changed = []
        for path in batch.created + batch.modified:
            indexer.index_single_file(path)
            self.metrics.files_indexed += 1
            changed.append(path)
        for path in batch.deleted:
            indexer.delete_file(path)
            self.metrics.files_deleted += 1
            changed.append(path)
        if changed:
            plan = PropagationManager(indexer.store).plan_for_files(changed)
            self.metrics.impacted_nodes += plan.total_impacted
            if plan.impacted:
                logger.info(
                    "change impact: %d nodes across %d files (top: %s)",
                    plan.total_impacted, len(plan.files_to_reanalyze),
                    ", ".join(i.name for i in plan.impacted[:5]),
                )

    def stop(self) -> None:
        self._stop.set()


class DaemonManager:
    """Spawn/stop/inspect the background daemon process (manager.rs:17)."""

    def __init__(self, config: CodeGraphConfig, device="cuda"):
        self.config = config
        self.device = str(device)

    def start(self, root: str) -> Dict:
        from codegraph_tpu_torch.index.flat import resolve_device

        # the child would die on a missing GPU where no one sees its stderr:
        # asking for CUDA without one raises here instead
        resolve_device(self.device)
        data_dir = str(self.config.resolved_data_dir())
        existing = read_pid(data_dir)
        if existing:
            return {"status": "already_running", "pid": existing}
        proc = subprocess.Popen(
            [sys.executable, "-m", "codegraph_tpu_torch.daemon", root,
             "--device", self.device],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            start_new_session=True,
        )
        write_pid(data_dir, proc.pid)
        return {"status": "started", "pid": proc.pid}

    def stop(self) -> Dict:
        data_dir = str(self.config.resolved_data_dir())
        pid = read_pid(data_dir)
        if not pid:
            return {"status": "not_running"}
        import signal

        try:
            os.kill(pid, signal.SIGTERM)
        except ProcessLookupError:
            # exited between read_pid's liveness check and the signal
            clear_pid(data_dir)
            return {"status": "not_running"}
        for _ in range(50):
            if not is_alive(pid):
                break
            time.sleep(0.1)
        clear_pid(data_dir)
        return {"status": "stopped", "pid": pid}

    def status(self) -> Dict:
        data_dir = str(self.config.resolved_data_dir())
        pid = read_pid(data_dir)
        return {"running": pid is not None, "pid": pid}


def _main(argv=None) -> None:
    import argparse

    from codegraph_tpu_torch.core.config import load_config

    ap = argparse.ArgumentParser(prog="codegraph_tpu_torch.daemon")
    ap.add_argument("root", nargs="?", default=".")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = args.root
    cfg = load_config()
    cfg.project_root = root
    daemon = WatchDaemon(cfg, root, device=args.device)
    import signal

    signal.signal(signal.SIGTERM, lambda *_: daemon.stop())
    daemon.run()


if __name__ == "__main__":
    _main()

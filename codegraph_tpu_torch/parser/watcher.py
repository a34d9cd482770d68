"""Copy of `codegraph_tpu/parser/watcher.py` for the PyTorch port.

Polling file watcher with debounce + batching.

Reference: crates/codegraph-parser/src/watcher.rs:59-960 (notify-based
recursive watch with debounce and BatchedChanges) and the intelligent
watcher (codegraph-core/src/watch/mod.rs:21-1759). No inotify binding is
available here, so changes detect by periodic stat/mtime scans — the
debounce/batch semantics are identical, and the interface matches what
the daemon session loop consumes (daemon/session.rs:88 next_batch).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

from codegraph_tpu_torch.parser.files import collect_source_files


@dataclass
class FileChange:
    path: str
    kind: str  # created | modified | deleted
    ts: float


@dataclass
class BatchedChanges:
    created: List[str] = field(default_factory=list)
    modified: List[str] = field(default_factory=list)
    deleted: List[str] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not (self.created or self.modified or self.deleted)


class FileWatcher:
    """Poll-scan a root; `next_batch()` returns debounced change batches."""

    def __init__(
        self,
        root: str,
        poll_interval_s: float = 0.5,
        debounce_s: float = 0.4,
        exclude_globs: Optional[Sequence[str]] = None,
    ):
        self.root = root
        self.poll_interval_s = poll_interval_s
        self.debounce_s = debounce_s
        self.exclude_globs = exclude_globs
        self._mtimes: Dict[str, float] = {}
        self._pending: Dict[str, FileChange] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._prime()

    def _scan(self) -> Dict[str, float]:
        files = collect_source_files(
            self.root, exclude_globs=self.exclude_globs, largest_first=False
        )
        out = {}
        for path, _ in files:
            try:
                out[path] = os.path.getmtime(path)
            except OSError:
                pass
        return out

    def _prime(self) -> None:
        self._mtimes = self._scan()

    def poll_once(self) -> None:
        """One scan cycle; records pending (debounced) changes."""
        now = time.monotonic()
        current = self._scan()
        with self._lock:
            for path, mtime in current.items():
                old = self._mtimes.get(path)
                if old is None:
                    self._pending[path] = FileChange(path, "created", now)
                elif mtime > old:
                    self._pending[path] = FileChange(path, "modified", now)
            for path in self._mtimes:
                if path not in current:
                    self._pending[path] = FileChange(path, "deleted", now)
            self._mtimes = current

    def next_batch(self) -> BatchedChanges:
        """Drain changes older than the debounce window."""
        now = time.monotonic()
        batch = BatchedChanges()
        with self._lock:
            ready = [
                c for c in self._pending.values()
                if now - c.ts >= self.debounce_s
            ]
            for c in ready:
                del self._pending[c.path]
                getattr(batch, c.kind).append(c.path)
        return batch

    # -- background thread -------------------------------------------------

    def start(self, on_batch: Callable[[BatchedChanges], None]) -> None:
        def loop():
            while not self._stop.is_set():
                self.poll_once()
                time.sleep(self.debounce_s)
                batch = self.next_batch()
                if not batch.empty:
                    on_batch(batch)
                self._stop.wait(self.poll_interval_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    # -- test hook (reference: simulate_file_event, indexer.rs:4389) -------

    def simulate_event(self, path: str, kind: str) -> None:
        with self._lock:
            self._pending[path] = FileChange(path, kind, 0.0)


__all__ = ["FileWatcher", "FileChange", "BatchedChanges"]

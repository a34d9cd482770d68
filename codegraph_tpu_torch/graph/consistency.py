"""Copy of `codegraph_tpu/graph/consistency.py` for the PyTorch port.

Transactional consistency over index/store mutations.

Reference: crates/codegraph-vector/src/consistency.rs:218-957 — MVCC
transactions with isolation levels (:12), a lock table (:163-206),
two-phase prepare/commit/abort (:481-639), visibility checks (:641),
checkpoints (:673-714), and a transaction log. Re-design: mutations
stage as an op list, prepare acquires per-key writer locks and
validates, commit applies atomically under a version counter, and
readers snapshot the committed version (single-writer apply keeps the
device index consistent — the reference's own writer-queue discipline,
SurrealWriterHandle indexer.rs:254).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional


class IsolationLevel(str, Enum):
    READ_COMMITTED = "read_committed"
    SNAPSHOT = "snapshot"


class TxnState(str, Enum):
    ACTIVE = "active"
    PREPARED = "prepared"
    COMMITTED = "committed"
    ABORTED = "aborted"


@dataclass
class Operation:
    kind: str          # "add" | "delete" | "upsert_meta"
    key: str           # lock key (e.g. file path or row-range label)
    apply: Callable[[], Any]
    undo: Optional[Callable[[], Any]] = None


@dataclass
class Transaction:
    txn_id: int
    isolation: IsolationLevel
    state: TxnState = TxnState.ACTIVE
    ops: List[Operation] = field(default_factory=list)
    locks: List[str] = field(default_factory=list)
    begin_version: int = 0
    started_at: float = field(default_factory=time.time)

    def stage(self, op: Operation) -> None:
        if self.state != TxnState.ACTIVE:
            raise RuntimeError(f"txn {self.txn_id} is {self.state}")
        self.ops.append(op)


@dataclass
class Checkpoint:
    version: int
    created_at: float
    label: str


class ConsistencyManager:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._locks: Dict[str, int] = {}  # key -> holding txn
        self._next_txn = 1
        self.version = 0
        self.txn_log: List[Dict] = []
        self.checkpoints: List[Checkpoint] = []

    # -- lifecycle ---------------------------------------------------------

    def begin(
        self, isolation: IsolationLevel = IsolationLevel.SNAPSHOT
    ) -> Transaction:
        with self._lock:
            txn = Transaction(
                txn_id=self._next_txn, isolation=isolation,
                begin_version=self.version,
            )
            self._next_txn += 1
            return txn

    def prepare(self, txn: Transaction) -> bool:
        """Phase 1: acquire writer locks for every op key; conflict ->
        abort (consistency.rs:481 prepare)."""
        with self._lock:
            if txn.state != TxnState.ACTIVE:
                return False
            needed = {op.key for op in txn.ops}
            for key in needed:
                holder = self._locks.get(key)
                if holder is not None and holder != txn.txn_id:
                    self._abort_locked(txn, f"lock conflict on {key!r}")
                    return False
            for key in needed:
                self._locks[key] = txn.txn_id
                txn.locks.append(key)
            txn.state = TxnState.PREPARED
            return True

    def commit(self, txn: Transaction) -> int:
        """Phase 2: apply ops in order; failure triggers undo of the
        applied prefix and abort (consistency.rs:540 commit)."""
        if txn.state != TxnState.PREPARED:
            raise RuntimeError(f"txn {txn.txn_id} not prepared")
        applied: List[Operation] = []
        try:
            for op in txn.ops:
                op.apply()
                applied.append(op)
        except Exception as exc:
            for op in reversed(applied):
                if op.undo:
                    try:
                        op.undo()
                    except Exception:
                        pass
            self.abort(txn, f"apply failed: {exc}")
            raise
        with self._lock:
            self.version += 1
            txn.state = TxnState.COMMITTED
            self._release_locked(txn)
            self.txn_log.append({
                "txn": txn.txn_id, "version": self.version,
                "ops": [(op.kind, op.key) for op in txn.ops],
                "ts": time.time(),
            })
            return self.version

    def abort(self, txn: Transaction, reason: str = "") -> None:
        with self._lock:
            self._abort_locked(txn, reason)

    def _abort_locked(self, txn: Transaction, reason: str) -> None:
        txn.state = TxnState.ABORTED
        self._release_locked(txn)
        self.txn_log.append({
            "txn": txn.txn_id, "aborted": True, "reason": reason,
            "ts": time.time(),
        })

    def _release_locked(self, txn: Transaction) -> None:
        for key in txn.locks:
            if self._locks.get(key) == txn.txn_id:
                del self._locks[key]
        txn.locks.clear()

    # -- visibility + checkpoints -----------------------------------------

    def is_visible(self, txn: Transaction, write_version: int) -> bool:
        """Snapshot isolation sees only versions <= begin_version;
        read-committed sees the latest (consistency.rs:641)."""
        if txn.isolation == IsolationLevel.SNAPSHOT:
            return write_version <= txn.begin_version
        return write_version <= self.version

    def checkpoint(self, label: str = "") -> Checkpoint:
        with self._lock:
            cp = Checkpoint(version=self.version, created_at=time.time(),
                            label=label)
            self.checkpoints.append(cp)
            return cp


__all__ = [
    "ConsistencyManager",
    "Transaction",
    "Operation",
    "Checkpoint",
    "IsolationLevel",
    "TxnState",
]

"""Copy of `codegraph_tpu/indexer/writer.py` for the PyTorch port.

Background writer: typed mutation jobs drained by a single worker.

Reference: crates/codegraph-mcp/src/indexer.rs:254-577 —
SurrealWriterHandle, an MPSC queue of typed jobs (Nodes / Edges /
NodeEmbeddings / SymbolEmbeddings / ChunkEmbeddings / FileMetadata)
applied by one writer task, so parsing/embedding never blocks on
storage. Here the store is in-process, but the same discipline decouples
the (TPU-bound) embed loop from (host-bound) store mutations and gives
single-writer consistency without locks on the hot path.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence


class JobKind(str, Enum):
    NODES = "nodes"
    EDGES = "edges"
    CHUNKS = "chunks"
    CHUNK_EMBEDDINGS = "chunk_embeddings"
    FILE_METADATA = "file_metadata"
    DELETE_FILE = "delete_file"


@dataclass
class WriteJob:
    kind: JobKind
    payload: Any


@dataclass
class WriterStats:
    enqueued: int = 0
    applied: int = 0
    failed: int = 0
    by_kind: Dict[str, int] = field(default_factory=dict)


class WriterHandle:
    """Single-writer queue over a GraphStore (+ optional vector index).

    enqueue_* methods return immediately; `flush()` blocks until every
    queued job is applied (the reference's flush + count verify,
    indexer.rs:1716).
    """

    def __init__(self, store, index=None, maxsize: int = 1024):
        self.store = store
        self.index = index
        self.stats = WriterStats()
        self._q: "queue.Queue[Optional[WriteJob]]" = queue.Queue(maxsize=maxsize)
        self._errors: List[str] = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- producers -----------------------------------------------------------

    def _put(self, kind: JobKind, payload: Any) -> None:
        self.stats.enqueued += 1
        self._q.put(WriteJob(kind, payload))

    def enqueue_nodes(self, nodes: Sequence) -> None:
        self._put(JobKind.NODES, list(nodes))

    def enqueue_edges(self, edges: Sequence) -> None:
        self._put(JobKind.EDGES, list(edges))

    def enqueue_chunks(self, chunks: Sequence) -> None:
        self._put(JobKind.CHUNKS, list(chunks))

    def enqueue_chunk_embeddings(self, chunks: Sequence, embeddings) -> None:
        self._put(JobKind.CHUNK_EMBEDDINGS, (list(chunks), embeddings))

    def enqueue_file_metadata(self, path: str, digest: str) -> None:
        self._put(JobKind.FILE_METADATA, (path, digest))

    def enqueue_delete_file(self, path: str) -> None:
        self._put(JobKind.DELETE_FILE, path)

    # -- worker ---------------------------------------------------------------

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                self._apply(job)
                self.stats.applied += 1
                self.stats.by_kind[job.kind.value] = (
                    self.stats.by_kind.get(job.kind.value, 0) + 1
                )
            except Exception as exc:  # record, keep draining (resilient
                # writes, surrealdb_storage.rs:675)
                self.stats.failed += 1
                self._errors.append(f"{job.kind.value}: {exc}")
            finally:
                self._q.task_done()

    def _apply(self, job: WriteJob) -> None:
        if job.kind == JobKind.NODES:
            self.store.upsert_nodes(job.payload)
        elif job.kind == JobKind.EDGES:
            self.store.add_edges(job.payload)
        elif job.kind == JobKind.CHUNKS:
            self.store.upsert_chunks(job.payload)
        elif job.kind == JobKind.CHUNK_EMBEDDINGS:
            chunks, embeddings = job.payload
            rows = self.store.upsert_chunks(chunks)
            if self.index is not None:
                got = self.index.add(embeddings)
                if list(got) != list(rows):
                    raise RuntimeError(
                        f"row drift: store {rows[:3]} vs index {list(got)[:3]}"
                    )
        elif job.kind == JobKind.FILE_METADATA:
            path, digest = job.payload
            self.store.record_file(path, digest)
        elif job.kind == JobKind.DELETE_FILE:
            _, chunk_rows = self.store.delete_file_data(job.payload)
            if self.index is not None and chunk_rows:
                import numpy as np

                self.index.delete(np.asarray(chunk_rows))

    # -- lifecycle -------------------------------------------------------------

    def flush(self) -> List[str]:
        """Block until the queue drains; returns (and clears) errors."""
        self._q.join()
        errors, self._errors = self._errors, []
        return errors

    def close(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=10)


__all__ = ["WriterHandle", "WriteJob", "JobKind", "WriterStats"]

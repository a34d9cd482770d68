"""Copy of `codegraph_tpu/graph/store.py` for the PyTorch port.

Host-side graph store: node/edge/chunk tables + snapshots.

Replaces the reference's SurrealDB storage layer
(crates/codegraph-graph/src/surrealdb_storage.rs:21-2030: batch upserts,
per-project deletes, file-scoped delete-then-insert, file_metadata change
detection) with an in-process store: records live in Python dicts /
numpy arrays, adjacency compiles to CSR (graph/csr.py) for device and
host queries, and persistence is an npz+jsonl snapshot directory instead
of a database process. Deterministic node ids (core/types.py) keep
re-indexing idempotent exactly as in the reference.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from codegraph_tpu_torch.core.errors import SnapshotError
from codegraph_tpu_torch.core.types import (
    EDGE_TYPE_CODES,
    CodeChunk,
    CodeEdge,
    CodeNode,
    EdgeType,
    Language,
    Location,
    NodeType,
)
from codegraph_tpu_torch.graph.csr import CSRGraph, build_csr

SNAPSHOT_VERSION = 1


class GraphStore:
    """Node/edge/chunk tables with stable row numbering.

    Rows are append-only per store lifetime; deletes tombstone
    (delete-then-insert incremental semantics, surrealdb_storage.rs:1302).
    """

    def __init__(self) -> None:
        self.nodes: Dict[str, CodeNode] = {}
        self.node_rows: Dict[str, int] = {}
        self.row_nodes: List[Optional[str]] = []  # row -> node id (None = dead)
        self.edges: List[CodeEdge] = []
        self.chunks: Dict[str, CodeChunk] = {}
        self.chunk_rows: Dict[str, int] = {}
        self.row_chunks: List[Optional[str]] = []  # embedding row -> chunk id
        self.file_nodes: Dict[str, List[str]] = {}  # file -> node ids
        self.file_metadata: Dict[str, str] = {}  # file -> content hash
        self._csr: Optional[CSRGraph] = None

    # -- upserts -----------------------------------------------------------

    def upsert_nodes(self, nodes: Sequence[CodeNode]) -> List[int]:
        """Insert/replace nodes; returns their rows (stable across upserts
        of the same deterministic id)."""
        rows = []
        for node in nodes:
            row = self.node_rows.get(node.id)
            if row is None:
                row = len(self.row_nodes)
                self.row_nodes.append(node.id)
                self.node_rows[node.id] = row
            node.row = row
            self.nodes[node.id] = node
            self.file_nodes.setdefault(node.location.file_path, [])
            if node.id not in self.file_nodes[node.location.file_path]:
                self.file_nodes[node.location.file_path].append(node.id)
            rows.append(row)
        self._csr = None
        return rows

    def add_edges(self, edges: Sequence[CodeEdge]) -> int:
        self.edges.extend(edges)
        self._csr = None
        return len(edges)

    def upsert_chunks(self, chunks: Sequence[CodeChunk]) -> List[int]:
        """Register chunks; rows index the embedding matrix."""
        rows = []
        for chunk in chunks:
            row = self.chunk_rows.get(chunk.id)
            if row is None:
                row = len(self.row_chunks)
                self.row_chunks.append(chunk.id)
                self.chunk_rows[chunk.id] = row
            chunk.row = row
            self.chunks[chunk.id] = chunk
            rows.append(row)
        return rows

    # -- deletes (file-scoped, delete-then-insert) -------------------------

    def delete_file_data(
        self,
        file_path: str,
        keep_node_ids: Optional[Sequence[str]] = None,
    ) -> Tuple[List[int], List[int]]:
        """Drop a file's nodes/edges/chunks. Returns (node_rows, chunk_rows)
        tombstoned — callers tombstone the same rows in the vector index.

        keep_node_ids enables SYMBOL-LEVEL incremental updates (reference:
        codegraph-core/src/watch/mod.rs:46,772 symbol-level change
        detection): the listed nodes — unchanged symbols of a modified
        file — survive with their rows, chunks, and incoming edges; only
        the rest is dropped. Edges SOURCED anywhere in the file are
        always dropped (the caller re-adds them from the fresh parse).
        """
        node_ids = self.file_nodes.pop(file_path, [])
        keep = set(keep_node_ids or ())
        file_set = set(node_ids)
        drop_set = file_set - keep
        node_rows, chunk_rows = [], []
        for nid in node_ids:
            if nid in keep:
                continue
            node = self.nodes.pop(nid, None)
            if node is None:
                continue
            row = self.node_rows.pop(nid, None)
            if row is not None:
                self.row_nodes[row] = None
                node_rows.append(row)
        # chunks of removed nodes
        dead_chunks = [
            c for c in self.chunks.values() if c.parent_node in drop_set
        ]
        for chunk in dead_chunks:
            del self.chunks[chunk.id]
            row = self.chunk_rows.pop(chunk.id, None)
            if row is not None:
                self.row_chunks[row] = None
                chunk_rows.append(row)
        if keep:
            # edges from this file get re-added by the caller's re-parse;
            # incoming edges to KEPT nodes from other files survive (the
            # all-or-nothing path below would sever them)
            self.edges = [
                e for e in self.edges
                if e.src not in file_set and e.dst not in drop_set
            ]
            self.file_nodes[file_path] = [n for n in node_ids if n in keep]
        else:
            self.edges = [
                e for e in self.edges
                if e.src not in file_set and e.dst not in file_set
            ]
        self.file_metadata.pop(file_path, None)
        self._csr = None
        return node_rows, chunk_rows

    # -- change detection (checkpoint/resume) ------------------------------

    def detect_file_changes(
        self, current: Dict[str, str]
    ) -> Tuple[List[str], List[str], List[str], List[str]]:
        """Compare content hashes vs stored file_metadata.

        Returns (added, modified, deleted, unchanged) — the reference's
        file_metadata change detector (indexer.rs:3186-3254).
        """
        added, modified, unchanged = [], [], []
        for path, digest in current.items():
            old = self.file_metadata.get(path)
            if old is None:
                added.append(path)
            elif old != digest:
                modified.append(path)
            else:
                unchanged.append(path)
        deleted = [p for p in self.file_metadata if p not in current]
        return added, modified, deleted, unchanged

    def record_file(self, path: str, digest: str) -> None:
        self.file_metadata[path] = digest

    # -- views -------------------------------------------------------------

    def node_by_row(self, row: int) -> Optional[CodeNode]:
        if 0 <= row < len(self.row_nodes):
            nid = self.row_nodes[row]
            return self.nodes.get(nid) if nid else None
        return None

    def chunk_by_row(self, row: int) -> Optional[CodeChunk]:
        if 0 <= row < len(self.row_chunks):
            cid = self.row_chunks[row]
            return self.chunks.get(cid) if cid else None
        return None

    def find_nodes_by_name(self, name: str, fuzzy: bool = True) -> List[CodeNode]:
        """Name lookup (reference: graph_functions.rs:473 find-by-name)."""
        name_l = name.lower()
        out = [n for n in self.nodes.values() if n.name == name]
        if not out and fuzzy:
            out = [n for n in self.nodes.values() if name_l in n.name.lower()]
        return out

    @property
    def n_node_rows(self) -> int:
        return len(self.row_nodes)

    def resolved_edge_arrays(
        self,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(src_rows, dst_rows, etype_codes, weights) for resolved edges."""
        src, dst, et, w = [], [], [], []
        for e in self.edges:
            if not e.resolved:
                continue
            s = self.node_rows.get(e.src)
            d = self.node_rows.get(e.dst)
            if s is None or d is None:
                continue
            src.append(s)
            dst.append(d)
            et.append(EDGE_TYPE_CODES[e.edge_type])
            w.append(e.weight)
        return (
            np.asarray(src, np.int64),
            np.asarray(dst, np.int64),
            np.asarray(et, np.int16),
            np.asarray(w, np.float32),
        )

    def csr(self) -> CSRGraph:
        if self._csr is None:
            src, dst, et, w = self.resolved_edge_arrays()
            self._csr = build_csr(self.n_node_rows, src, dst, et, w)
        return self._csr

    def stats(self) -> Dict[str, int]:
        return {
            "nodes": len(self.nodes),
            "edges": len(self.edges),
            "chunks": len(self.chunks),
            "files": len(self.file_metadata),
            "node_rows": len(self.row_nodes),
            "chunk_rows": len(self.row_chunks),
        }

    # -- snapshots ---------------------------------------------------------
    # Record files are gzip jsonl: code content compresses 3-5x (the
    # reference gets the same from zstd content compression,
    # CHANGELOG.md:111-112). Plain .jsonl from older snapshots still loads.

    def save(self, directory: str) -> None:
        """Snapshot to a directory: records as gzip jsonl + json meta
        (replaces the reference's DB persistence + PersistentVectorStore
        header/update-log format, persistent.rs:480-710)."""
        import gzip

        os.makedirs(directory, exist_ok=True)
        meta = {
            "version": SNAPSHOT_VERSION,
            "row_nodes": self.row_nodes,
            "row_chunks": self.row_chunks,
            "file_metadata": self.file_metadata,
            "file_nodes": self.file_nodes,
        }
        with open(os.path.join(directory, "store_meta.json"), "w") as f:
            json.dump(meta, f)

        def dump(name, records):
            with gzip.open(
                os.path.join(directory, name + ".jsonl.gz"), "wt"
            ) as f:
                for rec in records:
                    f.write(json.dumps(rec) + "\n")
            # remove any stale uncompressed copy
            plain = os.path.join(directory, name + ".jsonl")
            if os.path.exists(plain):
                os.remove(plain)

        def node_rec(node):
            rec = asdict(node)
            rec["node_type"] = node.node_type.value
            rec["language"] = node.language.value
            return rec

        def edge_rec(e):
            rec = asdict(e)
            rec["edge_type"] = e.edge_type.value
            return rec

        dump("nodes", (node_rec(n) for n in self.nodes.values()))
        dump("edges", (edge_rec(e) for e in self.edges))
        dump("chunks", (asdict(c) for c in self.chunks.values()))

    @staticmethod
    def _open_records(directory: str, name: str):
        import gzip

        gz = os.path.join(directory, name + ".jsonl.gz")
        if os.path.exists(gz):
            return gzip.open(gz, "rt")
        return open(os.path.join(directory, name + ".jsonl"))

    @classmethod
    def load(cls, directory: str) -> "GraphStore":
        meta_path = os.path.join(directory, "store_meta.json")
        if not os.path.exists(meta_path):
            raise SnapshotError(f"no snapshot at {directory}")
        store = cls()
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("version") != SNAPSHOT_VERSION:
            raise SnapshotError(f"unsupported snapshot version {meta.get('version')}")
        store.row_nodes = meta["row_nodes"]
        store.row_chunks = meta["row_chunks"]
        store.file_metadata = meta["file_metadata"]
        store.file_nodes = meta["file_nodes"]
        with cls._open_records(directory, "nodes") as f:
            for line in f:
                rec = json.loads(line)
                rec["node_type"] = NodeType(rec["node_type"])
                rec["language"] = Language(rec["language"])
                rec["location"] = Location(**rec["location"])
                node = CodeNode(**rec)
                store.nodes[node.id] = node
        store.node_rows = {
            nid: row for row, nid in enumerate(store.row_nodes) if nid
        }
        with cls._open_records(directory, "edges") as f:
            for line in f:
                rec = json.loads(line)
                rec["edge_type"] = EdgeType(rec["edge_type"])
                store.edges.append(CodeEdge(**rec))
        with cls._open_records(directory, "chunks") as f:
            for line in f:
                chunk = CodeChunk(**json.loads(line))
                store.chunks[chunk.id] = chunk
        store.chunk_rows = {
            cid: row for row, cid in enumerate(store.row_chunks) if cid
        }
        return store


__all__ = ["GraphStore", "SNAPSHOT_VERSION"]

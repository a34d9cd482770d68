"""Copy of `codegraph_tpu/graph/archive.py` for the PyTorch port.

Zero-deserialize graph archives: mmap-backed columnar graph snapshots.

Re-implements the reference's rkyv archived-graph layer
(codegraph-zerocopy/src/archived.rs:1-459 + serialization.rs:1-357:
zero-copy archived `CodeNode`/graph access straight out of an mmap) in
the rebuild's idiom: the graph becomes columnar numpy arrays — string
pools with offset tables for names/paths/contents, uint8 code columns
for enums, precomputed forward+reverse CSR — persisted through
index/snapshot.save_arrays (raw .npy + digest manifest). Opening an
archive is O(1): every column loads as a read-only memory map and node
records decode lazily on access, so an MCP server can answer graph
analytics over a multi-million-node snapshot without parsing a single
JSON line (the gzip-jsonl snapshot in graph/store.py remains the
full-fidelity mutable-load format; the archive is the serving format).

`ArchivedGraphStore` duck-types the query surface GraphQueries needs
(csr / node_by_row / node_rows.get / find_nodes_by_name / nodes.values),
so `GraphQueries(ArchivedGraphStore.open(dir))` serves all 8 analytics
read-only. Name lookup is a vectorized bytes-scan over the name pool
(occurrence offset -> row via searchsorted on the offset table), not a
Python loop.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from codegraph_tpu_torch.core.errors import SnapshotError
from codegraph_tpu_torch.core.types import (
    CodeNode,
    EdgeType,
    Language,
    Location,
    NodeType,
)
from codegraph_tpu_torch.graph.csr import CSRGraph
from codegraph_tpu_torch.graph.store import GraphStore
from codegraph_tpu_torch.index.snapshot import load_arrays, save_arrays

ARCHIVE_VERSION = 1


def _pool(strings: List[str]):
    """-> (pool uint8, offsets int64 [n+1]): string i = pool[o[i]:o[i+1]]."""
    blobs = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    pool = np.frombuffer(b"".join(blobs), np.uint8) if blobs else \
        np.zeros(0, np.uint8)
    return pool, offsets


def write_graph_archive(store: GraphStore, directory: str) -> str:
    """Archive a GraphStore's node table + resolved CSR. Returns the
    manifest path. Chunks/file-metadata stay in the jsonl snapshot (they
    belong to the index build, not the query surface)."""
    n = store.n_node_rows
    node_types = [t.value for t in NodeType]
    languages = [l.value for l in Language]
    ntype_code = {v: i for i, v in enumerate(node_types)}
    lang_code = {v: i for i, v in enumerate(languages)}

    ids, names, contents, metas = [], [], [], []
    path_ids = np.zeros(n, np.int32)
    ntypes = np.zeros(n, np.uint8)
    langs = np.zeros(n, np.uint8)
    lines = np.zeros((n, 2), np.int32)
    complexity = np.zeros(n, np.int32)
    alive = np.zeros(n, bool)
    path_index: Dict[str, int] = {}
    paths: List[str] = []

    for row in range(n):
        node = store.node_by_row(row)
        if node is None:
            ids.append("")
            names.append("")
            contents.append("")
            metas.append("")
            continue
        alive[row] = True
        ids.append(node.id)
        names.append(node.name)
        contents.append(node.content or "")
        metas.append(json.dumps(node.metadata) if node.metadata else "")
        p = node.location.file_path
        pid = path_index.get(p)
        if pid is None:
            pid = path_index[p] = len(paths)
            paths.append(p)
        path_ids[row] = pid
        ntypes[row] = ntype_code[node.node_type.value]
        langs[row] = lang_code[node.language.value]
        lines[row] = (node.location.start_line, node.location.end_line)
        complexity[row] = node.complexity

    name_pool, name_off = _pool(names)
    content_pool, content_off = _pool(contents)
    meta_pool, meta_off = _pool(metas)
    path_pool, path_off = _pool(paths)
    id_arr = np.array(ids, dtype="S40")  # SHA-256-derived UUIDs, 36 chars
    id_sort = np.argsort(id_arr).astype(np.int64)

    csr = store.csr()
    arrays = {
        "ids": id_arr.view(np.uint8).reshape(n, 40) if n else
        np.zeros((0, 40), np.uint8),
        "id_sort": id_sort,
        "name_pool": name_pool, "name_off": name_off,
        "content_pool": content_pool, "content_off": content_off,
        "meta_pool": meta_pool, "meta_off": meta_off,
        "path_pool": path_pool, "path_off": path_off,
        "path_ids": path_ids,
        "ntypes": ntypes, "langs": langs, "lines": lines,
        "complexity": complexity, "alive": alive,
        "indptr": csr.indptr, "indices": csr.indices,
        "etype": csr.etype, "weight": csr.weight,
        "r_indptr": csr.r_indptr, "r_indices": csr.r_indices,
        "r_etype": csr.r_etype, "r_weight": csr.r_weight,
    }
    meta = {
        "kind": "graph_archive", "version": ARCHIVE_VERSION,
        "n_nodes": n, "n_edges": int(csr.indices.shape[0]),
        "node_types": node_types, "languages": languages,
        "edge_types": [e.value for e in EdgeType],
    }
    return save_arrays(directory, arrays, meta)


def _decode(pool: np.ndarray, off: np.ndarray, i: int) -> str:
    return bytes(pool[off[i]:off[i + 1]]).decode("utf-8")


class _RowLookup:
    """node_rows.get(id) over the sorted id column (binary search)."""

    def __init__(self, store: "ArchivedGraphStore"):
        self._s = store

    def get(self, node_id: str, default=None):
        s = self._s
        key = node_id.encode("utf-8").ljust(40, b"\0")[:40]
        ids_sorted = s._ids_sorted
        i = np.searchsorted(ids_sorted, np.bytes_(key))
        if i < ids_sorted.shape[0] and ids_sorted[i] == key.rstrip(b"\0"):
            row = int(s.a["id_sort"][i])
            return row if s.a["alive"][row] else default
        return default


class _NodeView:
    """store.nodes duck-type: .values() iterates live nodes lazily."""

    def __init__(self, store: "ArchivedGraphStore"):
        self._s = store

    def values(self) -> Iterator[CodeNode]:
        s = self._s
        for row in np.nonzero(s.a["alive"])[0]:
            node = s.node_by_row(int(row))
            if node is not None:
                yield node

    def __len__(self) -> int:
        return int(self._s.a["alive"].sum())


class ArchivedGraphStore:
    """Read-only graph over mmap'd columns. Pass to GraphQueries for
    zero-deserialize analytics serving."""

    def __init__(self, arrays: Dict[str, np.ndarray], meta: Dict[str, Any]):
        if meta.get("kind") != "graph_archive":
            raise SnapshotError("not a graph archive")
        if meta.get("version") != ARCHIVE_VERSION:
            raise SnapshotError(
                f"graph archive version {meta.get('version')} != "
                f"{ARCHIVE_VERSION}"
            )
        self.a = arrays
        self.meta = meta
        # enum decode tables come from the archive, so an archive written
        # by an older enum set stays readable
        self._ntypes = [NodeType(v) for v in meta["node_types"]]
        self._langs = [Language(v) for v in meta["languages"]]
        self._ids_sorted = (
            arrays["ids"].reshape(-1).view("S40")[arrays["id_sort"]]
            if arrays["ids"].size else np.zeros(0, "S40")
        )
        self.node_rows = _RowLookup(self)
        self.nodes = _NodeView(self)
        self._csr: Optional[CSRGraph] = None

    @classmethod
    def open(cls, directory: str, verify: bool = True) -> "ArchivedGraphStore":
        arrays, meta = load_arrays(directory, mmap=True, verify=verify)
        return cls(arrays, meta)

    # -- query surface (GraphQueries duck-type) ------------------------

    @property
    def n_node_rows(self) -> int:
        return int(self.a["alive"].shape[0])

    def node_by_row(self, row: int) -> Optional[CodeNode]:
        a = self.a
        if row < 0 or row >= a["alive"].shape[0] or not a["alive"][row]:
            return None
        meta_s = _decode(a["meta_pool"], a["meta_off"], row)
        node = CodeNode(
            id=bytes(a["ids"][row]).rstrip(b"\0").decode(),
            name=_decode(a["name_pool"], a["name_off"], row),
            node_type=self._ntypes[a["ntypes"][row]],
            language=self._langs[a["langs"][row]],
            location=Location(
                file_path=_decode(a["path_pool"], a["path_off"],
                                  int(a["path_ids"][row])),
                start_line=int(a["lines"][row, 0]),
                end_line=int(a["lines"][row, 1]),
            ),
            content=_decode(a["content_pool"], a["content_off"], row),
            complexity=int(a["complexity"][row]),
        )
        if meta_s:
            node.metadata = json.loads(meta_s)
        node.row = row
        return node

    def find_nodes_by_name(self, name: str, fuzzy: bool = True
                           ) -> List[CodeNode]:
        """Pool scan with GraphStore semantics (store.py:167): exact
        case-sensitive matches first; only when none exist and fuzzy,
        case-insensitive substring matches. Occurrences map byte
        offset -> row via the offset table."""
        a = self.a
        if not name or a["name_pool"].size == 0:
            return []
        off = a["name_off"]

        def scan(hay: bytes, needle: bytes, exact_only: bool) -> List[int]:
            rows: List[int] = []
            seen = set()
            pos = hay.find(needle)
            while pos != -1:
                row = int(np.searchsorted(off, pos, side="right")) - 1
                end = pos + len(needle)
                if row not in seen and end <= off[row + 1] \
                        and a["alive"][row]:
                    if not exact_only or (off[row] == pos
                                          and off[row + 1] == end):
                        seen.add(row)
                        rows.append(row)
                pos = hay.find(needle, pos + 1)
            return rows

        hay = a["name_pool"].tobytes()
        rows = scan(hay, name.encode("utf-8"), exact_only=True)
        if not rows and fuzzy:
            rows = scan(hay.lower(), name.lower().encode("utf-8"),
                        exact_only=False)
        out = [self.node_by_row(r) for r in sorted(rows)]
        return [n for n in out if n is not None]

    def csr(self) -> CSRGraph:
        if self._csr is None:
            a = self.a
            self._csr = CSRGraph(
                n_nodes=self.n_node_rows,
                indptr=a["indptr"], indices=a["indices"],
                etype=a["etype"], weight=a["weight"],
                r_indptr=a["r_indptr"], r_indices=a["r_indices"],
                r_etype=a["r_etype"], r_weight=a["r_weight"],
            )
        return self._csr

    def stats(self) -> Dict[str, int]:
        return {
            "nodes": len(self.nodes),
            "edges": int(self.a["indices"].shape[0]),
            "node_rows": self.n_node_rows,
            "archived": 1,
        }


__all__ = ["write_graph_archive", "ArchivedGraphStore", "ARCHIVE_VERSION"]

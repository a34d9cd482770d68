"""Copy of `codegraph_tpu/search/filters.py` for the PyTorch port.

Device-side search-filter masks over chunk rows.

Reference: crates/codegraph-vector/src/search.rs:23-28 (SearchFilters),
:296-307 (post-filtering after prefetch) and the metadata-filtered KNN
variant (crates/codegraph-graph/src/surrealdb_storage.rs:331). The
reference filters AFTER retrieval, so a heavily-filtered query can lose
recall (prefetch_k candidates may all fail the filter). TPU-natively the
filter is applied INSIDE the scan: per-row attribute codes are
precomputed once per index generation, a query's filter compiles to a
[n_rows] f32 bias vector (0 = allowed, NEG_INF = excluded) that the
streaming top-k kernels add to their existing live/tombstone bias — zero
extra kernel work and exact filtered top-k.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from codegraph_tpu_torch.core.types import (
    LANGUAGE_CODES,
    NODE_TYPE_CODES,
    SearchFilters,
    path_prefix_match,
)
from codegraph_tpu_torch.ops.topk import NEG_INF


class FilterBank:
    """Per-chunk-row attribute codes + filter->bias compilation.

    Attributes are derived lazily from the GraphStore (chunk row ->
    parent node -> language/node_type/path/metadata) and cached until
    `invalidate()`. Compiled bias vectors are cached per filter key so
    repeated filtered queries reuse one device upload.
    """

    MAX_CACHED_FILTERS = 32

    def __init__(self, store):
        self.store = store
        self._rows_built = 0
        self._node_ids: List[str] = []
        self._node_index: Dict[str, int] = {}
        self._row_node: Optional[np.ndarray] = None   # [n_rows] -> node idx | -1
        self._node_lang: Optional[np.ndarray] = None  # [n_nodes] int16
        self._node_type: Optional[np.ndarray] = None  # [n_nodes] int16
        self._bias_cache: Dict[Tuple, np.ndarray] = {}

    def invalidate(self) -> None:
        self._rows_built = 0
        self._node_ids = []
        self._node_index = {}
        self._row_node = None
        self._node_lang = None
        self._node_type = None
        self._bias_cache = {}

    # -- attribute tables ---------------------------------------------------

    def _build(self, n_rows: int) -> None:
        if self._row_node is not None and self._rows_built >= n_rows:
            return
        store = self.store
        node_ids = list(store.nodes.keys())
        node_index = {nid: i for i, nid in enumerate(node_ids)}
        lang = np.full((len(node_ids),), -1, np.int16)
        ntype = np.full((len(node_ids),), -1, np.int16)
        for i, nid in enumerate(node_ids):
            node = store.nodes[nid]
            lang[i] = LANGUAGE_CODES.get(node.language, -1)
            ntype[i] = NODE_TYPE_CODES.get(node.node_type, -1)
        row_node = np.full((n_rows,), -1, np.int32)
        for row in range(n_rows):
            chunk = store.chunk_by_row(row)
            if chunk is None:
                continue
            idx = node_index.get(chunk.parent_node, -1)
            row_node[row] = idx
        self._node_ids = node_ids
        self._node_index = node_index
        self._node_lang = lang
        self._node_type = ntype
        self._row_node = row_node
        self._rows_built = n_rows
        self._bias_cache = {}

    def _allowed_nodes(self, filters: SearchFilters) -> np.ndarray:
        """Boolean [n_nodes]: which nodes pass the HARD filters."""
        store = self.store
        n = len(self._node_ids)
        allowed = np.ones((n,), bool)
        if filters.languages:
            codes = [
                LANGUAGE_CODES[l] for l in LANGUAGE_CODES
                if l.value in filters.languages
            ]
            allowed &= np.isin(self._node_lang, codes)
        if filters.node_types:
            codes = [
                NODE_TYPE_CODES[t] for t in NODE_TYPE_CODES
                if t.value in filters.node_types
            ]
            allowed &= np.isin(self._node_type, codes)
        if filters.path_prefixes or filters.attribute_equals:
            for i, nid in enumerate(self._node_ids):
                if not allowed[i]:
                    continue
                node = store.nodes.get(nid)
                if node is None:
                    allowed[i] = False
                    continue
                if filters.path_prefixes and not any(
                    path_prefix_match(node.location.file_path, p)
                    for p in filters.path_prefixes
                ):
                    allowed[i] = False
                    continue
                if filters.attribute_equals and not all(
                    str(node.metadata.get(k)) == v
                    for k, v in filters.attribute_equals
                ):
                    allowed[i] = False
        return allowed

    # -- public API ---------------------------------------------------------

    def bias_for(
        self, filters: Optional[SearchFilters], n_rows: int
    ) -> Optional[np.ndarray]:
        """[n_rows] f32 mask (0 allowed / NEG_INF excluded), or None when
        the filters exclude nothing. Rows with no resolvable parent node
        are excluded under any active filter (search.rs:421-424: missing
        node metadata fails the filter)."""
        if filters is None or filters.empty or n_rows == 0:
            return None
        self._build(n_rows)
        key = (filters.key(), n_rows)
        cached = self._bias_cache.get(key)
        if cached is not None:
            return cached
        allowed_nodes = self._allowed_nodes(filters)
        row_ok = np.zeros((n_rows,), bool)
        mapped = self._row_node[:n_rows] >= 0
        row_ok[mapped] = allowed_nodes[self._row_node[:n_rows][mapped]]
        bias = np.where(row_ok, 0.0, float(NEG_INF)).astype(np.float32)
        # bounded cache: each entry is an n_rows f32 array (4 MB at 1M
        # rows); agents fanning out distinct filters must not leak RAM
        if len(self._bias_cache) >= self.MAX_CACHED_FILTERS:
            self._bias_cache.pop(next(iter(self._bias_cache)))
        self._bias_cache[key] = bias
        return bias


__all__ = ["FilterBank"]

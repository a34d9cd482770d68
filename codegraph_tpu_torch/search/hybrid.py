"""Port of `codegraph_tpu/search/hybrid.py`: the same pipeline, with the
adjacency tables kept as tensors on the index's device for the boost.

Hybrid semantic search: vector top-k + BM25 + graph-adjacency boost.

The query hot path (SURVEY.md section 3.3). Reproduces the reference's
`fn::semantic_search_nodes_via_chunks` end-to-end semantics
(schema/codegraph.surql:328-536):

  1. encode query                      (models/providers)
  2. chunk-level vector top-k with 3x prefetch (search.rs:110-116)
  3. chunk -> parent-node enrich       (surql:399-418)
  4. BM25 text candidates              (surql:420-447)
  5. combined = 0.9*vector + 0.1*text  (surql:470-472)
  6. graph edge-context boost          (surql:481-536) — on device via
     the CSR adjacency kernel (graph/csr.py adjacency_boost), with the
     matching edges attached to each hit as `related` evidence
  7. sort / truncate / normalize       (search.rs:131-141)

plus SearchFilters (search.rs:23-28) applied DEVICE-SIDE as a bias mask
(search/filters.py), metadata match scoring (search.rs:461-515), the
reference's query-result cache (cache probe before encode) and
multi-query combine modes OrMax / AndAverage (search.rs:31-35).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.core.config import SearchConfig
from codegraph_tpu_torch.core.types import (
    EDGE_TYPE_BY_CODE,
    SearchFilters,
    SearchResult,
)
from codegraph_tpu_torch.graph.csr import adjacency_boost
from codegraph_tpu_torch.graph.store import GraphStore
from codegraph_tpu_torch.search.bm25 import BM25Index
from codegraph_tpu_torch.search.cache import SearchCache, query_key
from codegraph_tpu_torch.search.filters import FilterBank

logger = logging.getLogger("codegraph_tpu_torch.search")

SNIPPET_CHARS = 240


class HybridSearch:
    """Binds index + store + provider + BM25 into the query pipeline.

    `index` is any vector index with search(queries, k) -> (scores, rows)
    over *chunk* rows (FlatIndex / Int8FlatIndex / IVFIndex /
    ShardedFlatIndex all qualify). Indexes accepting an `extra_bias`
    kwarg get SearchFilters applied device-side; others fall back to the
    reference's host post-filter (search.rs:296-307).
    """

    def __init__(
        self,
        store: GraphStore,
        index,
        provider,
        bm25: Optional[BM25Index] = None,
        config: Optional[SearchConfig] = None,
        max_deg: int = 32,
        monitor=None,
    ):
        self.store = store
        self.index = index
        self.provider = provider
        self.bm25 = bm25 or BM25Index()
        self.config = config or SearchConfig()
        self.max_deg = max_deg
        self.cache = SearchCache(self.config.cache_size, self.config.cache_ttl_s)
        self.filters_bank = FilterBank(store)
        self._adj = None        # (nbr, wgt) device arrays for the boost kernel
        self._adj_host = None   # (nbr, wgt, etype, dir) np arrays for evidence
        # capability probe (NOT try/except TypeError, which would
        # misattribute an unrelated internal TypeError as "unsupported"
        # and silently disable device-side filtering)
        import inspect

        try:
            self._index_filter_ok = (
                "extra_bias" in inspect.signature(index.search).parameters
            )
        except (TypeError, ValueError):
            self._index_filter_ok = True
        if monitor is None:
            from codegraph_tpu_torch.utils.perfmon import PerformanceMonitor

            monitor = PerformanceMonitor()
        self.monitor = monitor

    # -- index maintenance hooks ------------------------------------------

    def invalidate(self) -> None:
        """Call after any index/graph mutation."""
        self.cache.invalidate()
        self.filters_bank.invalidate()
        self._adj = None
        self._adj_host = None

    def _adjacency(self):
        if self._adj is None:
            csr = self.store.csr()
            nbr, wgt, et, dirn = csr.padded_adjacency(max_deg=self.max_deg)
            self._adj_host = (nbr, wgt, et, dirn)
            # device-resident: converting per query would re-upload the
            # [n, max_deg] tables on every search
            device = getattr(self.index, "device", "cpu")
            self._adj = (torch.from_numpy(nbr).to(device),
                         torch.from_numpy(wgt).to(device))
        return self._adj

    # -- query path --------------------------------------------------------

    def search_text(
        self,
        query: str,
        limit: int = 0,
        filters: Optional[SearchFilters] = None,
    ) -> List[SearchResult]:
        limit = limit or self.config.default_limit
        limit = min(limit, self.config.max_limit)
        q = self.provider.embed_texts([query])[0]
        return self.search_embedding(q, limit, text_query=query,
                                     filters=filters)

    def _vector_search(self, embedding, prefetch, filters):
        """Stage 2 with SearchFilters as a device-side bias mask; falls
        back to host post-filtering when the index has no extra_bias."""
        q = embedding[None, :]
        if filters is None or filters.empty or filters.soft:
            # soft filters never exclude — they only feed the
            # metadata_match_score ranking term (search.rs:317-345)
            return self.index.search(q, prefetch)
        n_rows = getattr(self.index, "n_rows", 0) or 0
        eb = self.filters_bank.bias_for(filters, n_rows)
        if eb is not None and self._index_filter_ok:
            return self.index.search(q, prefetch, extra_bias=eb)
        # host fallback: over-fetch then drop filtered rows (reference
        # post-filter semantics, search.rs:296-307)
        scores, rows = self.index.search(q, min(prefetch * 4, max(n_rows, 1)))
        if eb is None:
            return scores[:, :prefetch], rows[:, :prefetch]
        s, r = scores[0], rows[0]
        safe = np.minimum(np.maximum(r, 0), eb.shape[0] - 1)
        bad = (r >= 0) & ((r >= eb.shape[0]) | (eb[safe] < 0))
        s = np.where(bad, -np.inf, s)
        r = np.where(bad, -1, r)
        order = np.argsort(-s, kind="stable")[:prefetch]
        return s[order][None, :], r[order][None, :]

    def search_embedding(
        self,
        embedding: np.ndarray,
        limit: int,
        text_query: str = "",
        filters: Optional[SearchFilters] = None,
    ) -> List[SearchResult]:
        if filters is not None and filters.empty:
            filters = None
        key = query_key(embedding, limit, text_query,
                        filters.key() if filters else None)
        cached = self.cache.get(key)
        if cached is not None:
            # fresh copies: downstream rerankers (reranker.py) and
            # search_multi's and_average overwrite r.score in place,
            # which would poison the cached objects for later hits
            import dataclasses

            # `related` is a mutable list of dicts: share it between the
            # cache and callers and an in-place edit poisons the cache
            return [
                dataclasses.replace(r, related=[dict(e) for e in r.related])
                for r in cached
            ]

        prefetch = max(limit * self.config.prefetch_multiplier, limit)
        with self.monitor.timer("vector_search_ms", "hybrid.vector_search"):
            scores, rows = self._vector_search(embedding, prefetch, filters)
        scores, rows = scores[0], rows[0]

        # chunk -> parent node: best chunk score per node, plus a
        # multi-hit bonus on the second-best — two chunks of one node
        # independently matching is stronger evidence than one chunk
        # (this is the aggregation the reference's chunk-mean node
        # embedding approximated, indexer.rs:1720-1725)
        node_top2: Dict[str, Tuple[float, float]] = {}
        node_chunk: Dict[str, str] = {}
        for score, row in zip(scores, rows):
            if row < 0:
                continue
            chunk = self.store.chunk_by_row(int(row))
            if chunk is None:
                continue
            nid = chunk.parent_node
            s = float(score)
            s1, s2 = node_top2.get(nid, (-np.inf, -np.inf))
            if s > s1:
                s1, s2 = s, s1
                node_chunk[nid] = chunk.id
            elif s > s2:
                s2 = s
            node_top2[nid] = (s1, s2)
        mhw = self.config.multi_hit_weight
        node_vec: Dict[str, float] = {
            nid: s1 + (mhw * max(s2, 0.0) if s2 > -np.inf else 0.0)
            for nid, (s1, s2) in node_top2.items()
        }

        # BM25 candidates: add text-only hits the vector pass missed
        # (filtered queries apply the same hard filter host-side — BM25
        # runs over nodes, not chunk rows)
        text_scores: Dict[str, float] = {}
        if text_query and self.bm25.n_docs > 0:
            for node_row, ts in self.bm25.search(text_query, limit=prefetch):
                node = self.store.node_by_row(int(node_row))
                if node is None:
                    continue
                if filters is not None and not filters.soft \
                        and not filters.matches_node(node):
                    continue
                text_scores[node.id] = float(ts)
            if text_scores:
                mx = max(text_scores.values())
                if mx > 0:
                    text_scores = {k: v / mx for k, v in text_scores.items()}

        cand_ids = list(node_vec.keys() | text_scores.keys())
        if not cand_ids:
            self.cache.put(key, [])
            return []

        vw, tw = self.config.vector_weight, self.config.text_weight
        combined = {
            nid: vw * node_vec.get(nid, 0.0) + tw * text_scores.get(nid, 0.0)
            for nid in cand_ids
        }

        # graph-adjacency boost over the candidate set (device kernel)
        cand_rows = np.asarray(
            [self.store.node_rows.get(nid, -1) for nid in cand_ids], np.int32
        )
        boosts = self._graph_boost(cand_ids, cand_rows)

        mw = self.config.metadata_weight if filters is not None else 0.0
        bw = self.config.graph_boost_weight
        results: List[SearchResult] = []
        for nid in cand_ids:
            node = self.store.nodes.get(nid)
            if node is None:
                continue
            meta_score = (
                filters.metadata_match_score(node) if mw else 0.0
            )
            score = combined[nid] + bw * boosts.get(nid, 0.0) + mw * meta_score
            results.append(
                SearchResult(
                    node_id=nid,
                    chunk_id=node_chunk.get(nid, ""),
                    score=score,
                    vector_score=node_vec.get(nid, 0.0),
                    text_score=text_scores.get(nid, 0.0),
                    graph_boost=boosts.get(nid, 0.0),
                    metadata_score=meta_score,
                    name=node.name,
                    node_type=node.node_type.value,
                    file_path=node.location.file_path,
                    start_line=node.location.start_line,
                    end_line=node.location.end_line,
                    snippet=node.content[:SNIPPET_CHARS],
                )
            )
        results.sort(key=lambda r: -r.score)
        results = results[:limit]
        self._attach_related(results, cand_rows)
        # cache pristine COPIES: the list handed to the caller gets
        # mutated in place by rerankers/search_multi
        import dataclasses

        self.cache.put(key, [
            dataclasses.replace(r, related=[dict(e) for e in r.related])
            for r in results
        ])
        return results

    def _graph_boost(
        self, cand_ids: Sequence[str], cand_rows: np.ndarray
    ) -> Dict[str, float]:
        if self.store.n_node_rows == 0 or not self.store.edges:
            return {}
        nbr, wgt = self._adjacency()
        if nbr.shape[0] == 0:
            return {}
        cand = torch.from_numpy(cand_rows[None, :]).to(nbr.device)
        boost = adjacency_boost(cand, nbr, wgt)[0].cpu().numpy()
        if boost.max() > 0:
            boost = boost / boost.max()  # normalize to [0, 1]
        return {nid: float(b) for nid, b in zip(cand_ids, boost)}

    def _attach_related(
        self, results: List[SearchResult], cand_rows: np.ndarray
    ) -> None:
        """Attach per-hit edge EVIDENCE: which candidate neighbors each
        result connects to, via what relation. The reference returns the
        joined edge rows with every hit (schema/codegraph.surql:481-536,
        graph_functions.rs:519 semantic_search_with_context); the boost
        kernel only keeps the weight sum, so the evidence is recovered
        host-side from the same padded adjacency over the final hits —
        O(limit * max_deg) work."""
        if self._adj_host is None or not results:
            return
        nbr, wgt, et, dirn = self._adj_host
        if nbr.shape[0] == 0:
            return
        cand_set = set(int(r) for r in cand_rows if r >= 0)
        cap = self.config.related_limit
        for res in results:
            row = self.store.node_rows.get(res.node_id, -1)
            if row < 0 or row >= nbr.shape[0]:
                continue
            entries = []
            for j in range(nbr.shape[1]):
                dst = int(nbr[row, j])
                if dst < 0:
                    break  # -1 padded tail
                if dst == row or dst not in cand_set:
                    continue
                other = self.store.node_by_row(dst)
                if other is None:
                    continue
                ecode = int(et[row, j])
                etype = EDGE_TYPE_BY_CODE.get(ecode)
                entries.append({
                    "node_id": other.id,
                    "name": other.name,
                    "relation": etype.value if etype else str(ecode),
                    "direction": "out" if int(dirn[row, j]) == 0 else "in",
                    "weight": round(float(wgt[row, j]), 6),
                })
            entries.sort(key=lambda e: -e["weight"])
            res.related = entries[:cap]

    def search_chunks(
        self, query: str, limit: int = 10
    ) -> List[Dict[str, Any]]:
        """Chunk-level results (reference:
        fn::semantic_search_chunks_with_context, surql:538): the raw
        retrieval units with their parent-node context attached."""
        q = self.provider.embed_texts([query])[0]
        scores, rows = self.index.search(q[None, :], limit)
        out: List[Dict[str, Any]] = []
        for score, row in zip(scores[0], rows[0]):
            if row < 0:
                continue
            chunk = self.store.chunk_by_row(int(row))
            if chunk is None:
                continue
            node = self.store.nodes.get(chunk.parent_node)
            out.append({
                "chunk_id": chunk.id,
                "score": round(float(score), 6),
                "text": chunk.text[:SNIPPET_CHARS],
                "chunk_index": chunk.chunk_index,
                "n_chunks": chunk.n_chunks,
                "parent_node": chunk.parent_node,
                "parent_name": node.name if node else "",
                "file_path": node.location.file_path if node else "",
                "start_line": node.location.start_line if node else 0,
            })
        return out

    # -- multi-vector combine (search.rs:31-35) ----------------------------

    def search_multi(
        self,
        embeddings: np.ndarray,
        limit: int,
        mode: str = "or_max",
        filters: Optional[SearchFilters] = None,
    ) -> List[SearchResult]:
        """Multiple query vectors combined OrMax (union, max score) or
        AndAverage (intersection, mean score)."""
        per_query = [
            self.search_embedding(e, limit * 2, filters=filters)
            for e in embeddings
        ]
        merged: Dict[str, SearchResult] = {}
        counts: Dict[str, int] = {}
        sums: Dict[str, float] = {}
        for results in per_query:
            for r in results:
                counts[r.node_id] = counts.get(r.node_id, 0) + 1
                sums[r.node_id] = sums.get(r.node_id, 0.0) + r.score
                if r.node_id not in merged or r.score > merged[r.node_id].score:
                    merged[r.node_id] = r
        out = []
        for nid, r in merged.items():
            if mode == "and_average":
                if counts[nid] < len(per_query):
                    continue
                r.score = sums[nid] / counts[nid]
            out.append(r)
        out.sort(key=lambda r: -r.score)
        return out[:limit]


__all__ = ["HybridSearch"]

"""Copy of `codegraph_tpu/rag/retriever.py` for the PyTorch port.

Context retrieval: semantic / keyword / hybrid over the index.

Reference: crates/codegraph-vector/src/rag/context_retriever.rs:49-513 —
RetrievalMethod (:19-26), node cache, dedup.
"""

from __future__ import annotations

from enum import Enum
from typing import List

from codegraph_tpu_torch.core.types import SearchResult
from codegraph_tpu_torch.rag.query_processor import ProcessedQuery


class RetrievalMethod(str, Enum):
    SEMANTIC = "semantic"
    KEYWORD = "keyword"
    HYBRID = "hybrid"


class ContextRetriever:
    """Thin policy layer over HybridSearch: picks the retrieval method
    from the processed query and merges entity-targeted lookups."""

    def __init__(self, hybrid_search, store):
        self.search = hybrid_search
        self.store = store

    def retrieve(
        self,
        pq: ProcessedQuery,
        limit: int = 10,
        method: RetrievalMethod = RetrievalMethod.HYBRID,
        filters=None,
    ) -> List[SearchResult]:
        """filters: optional core.types.SearchFilters, applied device-side
        by HybridSearch (search.rs:23-28 parity)."""
        results: List[SearchResult] = []
        if method in (RetrievalMethod.SEMANTIC, RetrievalMethod.HYBRID):
            results = self.search.search_text(pq.expanded_query, limit,
                                              filters=filters)
        elif method == RetrievalMethod.KEYWORD:
            hits = self.search.bm25.search(pq.raw, limit)
            for row, score in hits:
                node = self.store.node_by_row(int(row))
                if node is None:
                    continue
                results.append(SearchResult(
                    node_id=node.id, chunk_id="", score=float(score),
                    text_score=float(score), name=node.name,
                    node_type=node.node_type.value,
                    file_path=node.location.file_path,
                    start_line=node.location.start_line,
                    end_line=node.location.end_line,
                    snippet=node.content[:240],
                ))
        # entity lookups: exact names mentioned in the query always join
        seen = {r.node_id for r in results}
        for ent in pq.entities:
            name = ent.rstrip("()").split("::")[-1].split(".")[-1]
            for node in self.store.find_nodes_by_name(name)[:2]:
                if node.id not in seen:
                    seen.add(node.id)
                    results.append(SearchResult(
                        node_id=node.id, chunk_id="", score=0.5,
                        name=node.name, node_type=node.node_type.value,
                        file_path=node.location.file_path,
                        start_line=node.location.start_line,
                        end_line=node.location.end_line,
                        snippet=node.content[:240],
                    ))
        return results[: limit * 2]


__all__ = ["ContextRetriever", "RetrievalMethod"]

"""Copy of `codegraph_tpu/rag/ranker.py` for the PyTorch port.

Weighted result ranking with a score breakdown.

Reference: crates/codegraph-vector/src/rag/result_ranker.rs:58-606 —
similarity/recency/popularity weights, ScoreBreakdown (:49).
Popularity feeds back from answer usage (rag_system.rs:381).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from codegraph_tpu_torch.core.types import SearchResult


@dataclass
class ScoreBreakdown:
    similarity: float = 0.0
    text: float = 0.0
    graph: float = 0.0
    popularity: float = 0.0
    final: float = 0.0


@dataclass
class RankerWeights:
    similarity: float = 0.6
    text: float = 0.15
    graph: float = 0.1
    popularity: float = 0.15


class ResultRanker:
    def __init__(self, weights: RankerWeights | None = None):
        self.weights = weights or RankerWeights()
        self._popularity: Dict[str, float] = {}

    def record_usage(self, node_id: str) -> None:
        """Popularity feedback (rag_system.rs:381)."""
        self._popularity[node_id] = self._popularity.get(node_id, 0.0) + 1.0

    def rank(
        self, results: List[SearchResult]
    ) -> List[tuple[SearchResult, ScoreBreakdown]]:
        max_pop = max(self._popularity.values(), default=1.0)
        w = self.weights
        scored = []
        for r in results:
            pop = self._popularity.get(r.node_id, 0.0) / max_pop
            bd = ScoreBreakdown(
                similarity=r.vector_score or r.score,
                text=r.text_score,
                graph=r.graph_boost,
                popularity=pop,
            )
            bd.final = (
                w.similarity * bd.similarity + w.text * bd.text
                + w.graph * bd.graph + w.popularity * bd.popularity
            )
            scored.append((r, bd))
        scored.sort(key=lambda t: -t[1].final)
        return scored


__all__ = ["ResultRanker", "RankerWeights", "ScoreBreakdown"]

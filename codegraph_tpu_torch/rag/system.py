"""Copy of `codegraph_tpu/rag/system.py` for the PyTorch port.

RAG orchestrator with a latency budget.

Reference: crates/codegraph-vector/src/rag/rag_system.rs:62-546 —
process_query = analyze -> retrieve -> rank -> generate under a latency
budget (:125-235); over-budget stages degrade (skip LLM, fewer results)
rather than fail.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from codegraph_tpu_torch.rag.generator import GeneratedResponse, ResponseGenerator
from codegraph_tpu_torch.rag.query_processor import QueryProcessor
from codegraph_tpu_torch.rag.ranker import ResultRanker
from codegraph_tpu_torch.rag.retriever import ContextRetriever, RetrievalMethod


@dataclass
class RAGConfig:
    latency_budget_ms: float = 200.0  # reference target: RAG 200->100 ms
    max_results: int = 10
    method: RetrievalMethod = RetrievalMethod.HYBRID


@dataclass
class RAGAnswer:
    response: GeneratedResponse
    query_type: str
    latency_ms: float
    stage_ms: Dict[str, float] = field(default_factory=dict)
    degraded: bool = False


class RAGSystem:
    def __init__(
        self,
        hybrid_search,
        store,
        llm=None,
        config: Optional[RAGConfig] = None,
    ):
        self.config = config or RAGConfig()
        self.processor = QueryProcessor()
        self.retriever = ContextRetriever(hybrid_search, store)
        self.ranker = ResultRanker()
        self.generator = ResponseGenerator(llm)

    def process_query(self, query: str) -> RAGAnswer:
        t_start = time.perf_counter()
        budget_s = self.config.latency_budget_ms / 1000.0
        stage_ms: Dict[str, float] = {}
        degraded = False

        t0 = time.perf_counter()
        pq = self.processor.process(query)
        stage_ms["analyze"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        results = self.retriever.retrieve(
            pq, limit=self.config.max_results, method=self.config.method
        )
        stage_ms["retrieve"] = (time.perf_counter() - t0) * 1000

        t0 = time.perf_counter()
        ranked = self.ranker.rank(results)
        results = [r for r, _ in ranked][: self.config.max_results]
        stage_ms["rank"] = (time.perf_counter() - t0) * 1000

        # over budget -> skip the LLM polish (degrade, don't fail)
        t0 = time.perf_counter()
        gen = self.generator
        if time.perf_counter() - t_start > budget_s:
            degraded = True
            gen = ResponseGenerator(llm=None)
        response = gen.generate(pq, results)
        stage_ms["generate"] = (time.perf_counter() - t0) * 1000

        for r in results[:3]:
            self.ranker.record_usage(r.node_id)

        return RAGAnswer(
            response=response,
            query_type=pq.query_type.value,
            latency_ms=(time.perf_counter() - t_start) * 1000,
            stage_ms=stage_ms,
            degraded=degraded,
        )


__all__ = ["RAGSystem", "RAGConfig", "RAGAnswer"]

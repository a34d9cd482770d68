"""Copy of `codegraph_tpu/rag/__init__.py` for the PyTorch port.

RAG subsystem: query understanding -> retrieval -> ranking -> answer.

Re-implements the reference's RAG family
(crates/codegraph-vector/src/rag/: rag_system.rs:62-546 process_query
with latency budget, query_processor.rs:27-410 classification/expansion,
context_retriever.rs:49-513 semantic/keyword/hybrid retrieval,
result_ranker.rs:58-606 weighted ScoreBreakdown,
response_generator.rs:59-934 template+LLM synthesis; plus
insights_generator.rs:73-338).
"""

from codegraph_tpu_torch.rag.query_processor import QueryProcessor, QueryType
from codegraph_tpu_torch.rag.retriever import ContextRetriever, RetrievalMethod
from codegraph_tpu_torch.rag.ranker import ResultRanker, ScoreBreakdown
from codegraph_tpu_torch.rag.generator import ResponseGenerator
from codegraph_tpu_torch.rag.system import RAGSystem
from codegraph_tpu_torch.rag.insights import InsightsGenerator

__all__ = [
    "QueryProcessor",
    "QueryType",
    "ContextRetriever",
    "RetrievalMethod",
    "ResultRanker",
    "ScoreBreakdown",
    "ResponseGenerator",
    "RAGSystem",
    "InsightsGenerator",
]

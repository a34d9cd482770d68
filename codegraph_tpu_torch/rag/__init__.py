"""RAG subsystem: the query processor (the rest of `codegraph_tpu/rag/`,
retrieval, ranking, generation and insights, waits for ROADMAP item 19)."""

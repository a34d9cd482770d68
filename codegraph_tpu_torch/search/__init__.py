"""Hybrid search, BM25, result cache, filters and the batching query service."""

"""Copy of `codegraph_tpu/mcp/tools.py` for the PyTorch port; a `router`
(multi-model routing, `search/router.py`) raises NotImplementedError until
ROADMAP item 19 ports it, so the `model` tool parameter is ignored, as it is
in the JAX package with its default router=None.

Agent-facing graph tools: the 8-tool executor + JSON schemas.

Reference: codegraph-mcp-tools/src/graph_tool_executor.rs:76-939 —
dispatch over get_transitive_dependencies / detect_circular_dependencies
/ trace_call_chain / calculate_coupling_metrics / get_hub_nodes /
get_reverse_dependencies / semantic_code_search / find_complexity_hotspots
(:326-352), semantic search with optional rerank (:548-607), LRU result
cache (:161-189); schemas with depth clamps <= 5
(graph_tool_schemas.rs:36-262).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Optional

from codegraph_tpu_torch.graph.queries import GraphQueries
from codegraph_tpu_torch.search.cache import SearchCache
from codegraph_tpu_torch.search.reranker import RerankerPipeline
from codegraph_tpu_torch.utils.debug_logger import DebugLogger

logger = logging.getLogger("codegraph_tpu_torch.tools")


def _int_schema(desc, default=None, minimum=None, maximum=None):
    s = {"type": "integer", "description": desc}
    if default is not None:
        s["default"] = default
    if minimum is not None:
        s["minimum"] = minimum
    if maximum is not None:
        s["maximum"] = maximum
    return s


TOOL_SCHEMAS: Dict[str, Dict[str, Any]] = {
    "semantic_code_search": {
        "name": "semantic_code_search",
        "description": "Hybrid semantic+text search over the code graph; "
                       "returns ranked nodes with scores and graph context.",
        "parameters": {
            "type": "object",
            "properties": {
                "query": {"type": "string", "description": "natural language or code query"},
                "limit": _int_schema("max results", 10, 1, 100),
                "rerank": {"type": "boolean",
                           "description": "override the server's rerank "
                                          "default (on since r5)"},
                "model": {
                    "type": "string",
                    "description": "route to a named index backend in a "
                                   "multi-model deployment (omit for the "
                                   "default)",
                },
                # SearchFilters (reference: search.rs:23-28 + the
                # metadata-filtered KNN, surrealdb_storage.rs:331)
                "languages": {
                    "type": "array", "items": {"type": "string"},
                    "description": "only hits in these languages "
                                   "(e.g. ['rust', 'python'])",
                },
                "node_types": {
                    "type": "array", "items": {"type": "string"},
                    "description": "only these node kinds "
                                   "(e.g. ['function', 'struct'])",
                },
                "path_prefixes": {
                    "type": "array", "items": {"type": "string"},
                    "description": "only files under these path prefixes",
                },
                "metadata": {
                    "type": "object",
                    "description": "attribute equals-filters on node "
                                   "metadata (key: expected value)",
                },
                "filter_mode": {
                    "type": "string", "enum": ["hard", "soft"],
                    "default": "hard",
                    "description": "hard: exclude non-matching results; "
                                   "soft: filters only boost ranking "
                                   "(partial matches allowed)",
                },
            },
            "required": ["query"],
        },
    },
    "get_transitive_dependencies": {
        "name": "get_transitive_dependencies",
        "description": "Everything a node depends on, to a bounded depth.",
        "parameters": {
            "type": "object",
            "properties": {
                "node": {"type": "string", "description": "node id or name"},
                "max_depth": _int_schema("traversal depth", 3, 1, 5),
            },
            "required": ["node"],
        },
    },
    "detect_circular_dependencies": {
        "name": "detect_circular_dependencies",
        "description": "Strongly-connected components (dependency cycles).",
        "parameters": {"type": "object", "properties": {
            "max_cycles": _int_schema("max cycles to report", 50, 1, 200),
        }},
    },
    "trace_call_chain": {
        "name": "trace_call_chain",
        "description": "Call paths from a source function (optionally to a target).",
        "parameters": {
            "type": "object",
            "properties": {
                "source": {"type": "string"},
                "target": {"type": "string"},
                "max_depth": _int_schema("max path length", 5, 1, 5),
            },
            "required": ["source"],
        },
    },
    "calculate_coupling_metrics": {
        "name": "calculate_coupling_metrics",
        "description": "Afferent/efferent coupling + instability for a node.",
        "parameters": {
            "type": "object",
            "properties": {"node": {"type": "string"}},
            "required": ["node"],
        },
    },
    "get_hub_nodes": {
        "name": "get_hub_nodes",
        "description": "Most-connected nodes (architectural hubs).",
        "parameters": {"type": "object", "properties": {
            "limit": _int_schema("max hubs", 10, 1, 50),
        }},
    },
    "get_reverse_dependencies": {
        "name": "get_reverse_dependencies",
        "description": "Everything that depends on a node (impact set).",
        "parameters": {
            "type": "object",
            "properties": {
                "node": {"type": "string"},
                "max_depth": _int_schema("traversal depth", 2, 1, 5),
            },
            "required": ["node"],
        },
    },
    "find_nodes_by_name": {
        "name": "find_nodes_by_name",
        "description": "Look up graph nodes by exact or fuzzy symbol "
                       "name (reference: graph_functions.rs:473).",
        "parameters": {
            "type": "object",
            "properties": {
                "name": {"type": "string"},
                "limit": {"type": "integer", "default": 20},
            },
            "required": ["name"],
        },
    },
    "find_complexity_hotspots": {
        "name": "find_complexity_hotspots",
        "description": "Highest complexity x connectivity nodes.",
        "parameters": {"type": "object", "properties": {
            "limit": _int_schema("max hotspots", 10, 1, 50),
        }},
    },
}


class GraphToolExecutor:
    """Dispatch + result cache over the 8 tools."""

    def __init__(
        self,
        queries: GraphQueries,
        hybrid_search,
        reranker: Optional[RerankerPipeline] = None,
        cache_size: int = 256,
        debug: Optional[DebugLogger] = None,
        router=None,
        rerank_default: bool = True,
    ):
        """router: optional search.router.IndexRouter for multi-model
        deployments — the `model` tool parameter routes the query to the
        named backend (reference: per-dimension column routing,
        surrealdb_storage.rs:1932).

        rerank_default: what an omitted `rerank` tool param means —
        wired from SearchConfig.rerank (True since r5: the feature
        reranker measured net-positive at ~zero latency)."""
        if router is not None:
            raise NotImplementedError(
                "a router for the `model` tool parameter (search/router.py) is "
                "not ported yet: ROADMAP item 19")
        self.queries = queries
        self.search = hybrid_search
        self.reranker = reranker
        self.rerank_default = bool(rerank_default)
        self.router = router
        self.cache = SearchCache(max_size=cache_size, ttl_s=120.0)
        self.debug = debug or DebugLogger()
        self.call_counts: Dict[str, int] = {}

    def execute(self, tool: str, params: Dict[str, Any]) -> Dict[str, Any]:
        self.call_counts[tool] = self.call_counts.get(tool, 0) + 1
        cache_key = f"{tool}:{json.dumps(params, sort_keys=True, default=str)}"
        cached = self.cache.get(cache_key)
        if cached is not None:
            return cached
        try:
            result = self._dispatch(tool, params)
        except Exception as exc:
            logger.exception("tool %s failed", tool)
            result = {"error": f"{type(exc).__name__}: {exc}"}
            # errors are NOT cached: a transient failure (e.g. an index
            # mid-swap) would otherwise stick for the whole TTL
            self.debug.tool_call(tool, params, json.dumps(result,
                                                          default=str))
            return result
        self.debug.tool_call(tool, params, json.dumps(result, default=str))
        self.cache.put(cache_key, result)
        return result

    def invalidate(self) -> None:
        """Drop cached tool results — call after index/graph mutation
        (the indexer invalidates its search cache the same way)."""
        self.cache.invalidate()
        self._path_vocab = None

    def _auto_filters(self, query: str):
        """Query-classified SOFT filters (rag/query_processor.py
        infer_soft_filters); the corpus path vocabulary is built lazily
        and dropped on invalidate()."""
        from codegraph_tpu_torch.rag.query_processor import (
            infer_soft_filters, path_vocabulary)

        vocab = getattr(self, "_path_vocab", None)
        if vocab is None:
            store = getattr(self.search, "store", None)
            nodes = list(store.nodes.values()) if store is not None else []
            vocab = path_vocabulary(nodes)
            self._path_vocab = vocab
        return infer_soft_filters(query, vocab)

    def _dispatch(self, tool: str, p: Dict[str, Any]) -> Dict[str, Any]:
        q = self.queries
        if tool == "semantic_code_search":
            from codegraph_tpu_torch.core.types import SearchFilters

            filters = None
            if any(p.get(f) for f in
                   ("languages", "node_types", "path_prefixes", "metadata")):
                filters = SearchFilters.make(
                    languages=p.get("languages"),
                    node_types=p.get("node_types"),
                    path_prefixes=p.get("path_prefixes"),
                    metadata=p.get("metadata"),
                    soft=(p.get("filter_mode") == "soft"),
                )
            elif p.get("auto_filters", True):
                # no explicit filters: classify the query into SOFT
                # filters (language/kind words + discriminative path
                # terms). Soft never excludes; it only feeds the
                # metadata_match_score ranking term — VERDICT r4 weak 7
                filters = self._auto_filters(p["query"])
            if p.get("model") and self.router is not None:
                results = self.router.search_text(
                    p["query"], int(p.get("limit", 10)),
                    model=p["model"], filters=filters,
                )
            else:
                results = self.search.search_text(
                    p["query"], int(p.get("limit", 10)), filters=filters
                )
            if p.get("rerank", self.rerank_default) \
                    and self.reranker is not None:
                results = self.reranker.rerank(p["query"], results)
            return {"count": len(results),
                    "results": [r.to_dict() for r in results]}
        if tool == "get_transitive_dependencies":
            return q.transitive_dependencies(
                p["node"], int(p.get("max_depth", 3))
            )
        if tool == "detect_circular_dependencies":
            return q.circular_dependencies(
                max_cycles=int(p.get("max_cycles", 50))
            )
        if tool == "trace_call_chain":
            return q.trace_call_chain(
                p["source"], p.get("target"), int(p.get("max_depth", 5))
            )
        if tool == "calculate_coupling_metrics":
            return q.coupling_metrics(p["node"])
        if tool == "get_hub_nodes":
            return q.hub_nodes(int(p.get("limit", 10)))
        if tool == "get_reverse_dependencies":
            return q.reverse_dependencies(
                p["node"], int(p.get("max_depth", 2))
            )
        if tool == "find_complexity_hotspots":
            return q.complexity_hotspots(int(p.get("limit", 10)))
        if tool == "find_nodes_by_name":
            return q.find_nodes_by_name(p["name"], int(p.get("limit", 20)))
        return {"error": f"unknown tool {tool!r}"}

    def stats(self) -> Dict[str, Any]:
        return {"calls": dict(self.call_counts), "cache": self.cache.stats()}


__all__ = ["GraphToolExecutor", "TOOL_SCHEMAS"]

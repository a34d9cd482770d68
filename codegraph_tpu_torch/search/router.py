"""Copy of `codegraph_tpu/search/router.py` for the PyTorch port.

Multi-index / per-dimension serving router.

Reference: the reference serves NINE embedding dimensions concurrently —
`surreal_embedding_column_for_dimension` routes each vector to the
matching `chunks.embedding_<dim>` HNSW column (surrealdb_storage.rs:1932)
and `SurrealVectorStore` picks the column per query dimension
(surreal_store.rs:67). The rebuild owns one HBM index per process config,
so a multi-model deployment (e.g. encoder 512-d + ensemble 768-d, or a
per-language model family) needs an explicit routing layer: this module.

Design: a registry of named backends, each = (provider, searcher) where
`searcher` exposes `search_text(text, limit, ...)` (a HybridSearch) or a
raw `search(queries, k)` index. Routing keys, in precedence order:

1. explicit model name (the MCP `model` parameter / CLI flag),
2. query-vector dimension (the reference's routing key — raw-vector
   queries land on the backend whose index width matches),
3. the registered default.

All backends share one process and one chip: routing is a dict lookup,
the per-backend index is already HBM-resident, and queries batch within
their backend (compose each with QueryService for collection).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger("codegraph_tpu_torch_torch.search")


class RoutingError(KeyError):
    """No backend matches the requested model/dimension."""


class IndexRouter:
    """Named (provider, searcher) backends with model/dimension routing."""

    def __init__(self):
        self._backends: Dict[str, dict] = {}
        self._default: Optional[str] = None

    # -- registry ------------------------------------------------------------

    def register(self, name: str, provider, searcher,
                 default: bool = False) -> None:
        """provider: embed_texts + .dimension; searcher: HybridSearch
        (search_text) or a raw index (search). First registration
        becomes the default unless a later one claims it."""
        dim = int(getattr(provider, "dimension", 0))
        self._backends[name] = {
            "provider": provider,
            "searcher": searcher,
            "dimension": dim,
        }
        if default or self._default is None:
            self._default = name

    def names(self) -> List[str]:
        return sorted(self._backends)

    def dimensions(self) -> Dict[str, int]:
        return {n: b["dimension"] for n, b in self._backends.items()}

    # -- routing ---------------------------------------------------------------

    def resolve(self, model: Optional[str] = None,
                dimension: Optional[int] = None) -> str:
        if model is not None:
            if model not in self._backends:
                raise RoutingError(
                    f"unknown model {model!r}; available: {self.names()}")
            return model
        if dimension is not None:
            matches = [n for n, b in self._backends.items()
                       if b["dimension"] == int(dimension)]
            if len(matches) == 1:
                return matches[0]
            if len(matches) > 1:
                # ambiguous width: prefer the default when it matches,
                # else the lexicographically first for determinism
                if self._default in matches:
                    return self._default
                return sorted(matches)[0]
            raise RoutingError(
                f"no backend serves dimension {dimension}; have "
                f"{self.dimensions()}")
        if self._default is None:
            raise RoutingError("no backends registered")
        return self._default

    def backend(self, model: Optional[str] = None,
                dimension: Optional[int] = None) -> dict:
        return self._backends[self.resolve(model, dimension)]

    # -- query entry points ------------------------------------------------------

    def search_text(self, text: str, limit: int = 10,
                    model: Optional[str] = None, **kw):
        """Text query: explicit model, else the default backend. Returns
        whatever the backend's searcher returns (SearchResult list for
        HybridSearch)."""
        b = self.backend(model=model)
        searcher = b["searcher"]
        if hasattr(searcher, "search_text"):
            return searcher.search_text(text, limit, **kw)
        q = b["provider"].embed_texts([text])
        scores, rows = searcher.search(np.asarray(q, np.float32), limit, **kw)
        return scores[0], rows[0]

    def search_vector(self, query: np.ndarray, k: int = 10,
                      model: Optional[str] = None, **kw):
        """Raw-vector query: routes by the vector's width when no model
        is named (the reference's per-dimension column routing)."""
        q = np.asarray(query, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        b = self.backend(model=model, dimension=q.shape[1])
        searcher = b["searcher"]
        index = getattr(searcher, "index", searcher)
        return index.search(q, k, **kw)

    def stats(self) -> Dict[str, dict]:
        out = {}
        for name, b in self._backends.items():
            searcher = b["searcher"]
            index = getattr(searcher, "index", searcher)
            try:
                rows = len(index)
            except TypeError:
                rows = -1
            out[name] = {
                "dimension": b["dimension"],
                "rows": rows,
                "default": name == self._default,
            }
        return out


__all__ = ["IndexRouter", "RoutingError"]

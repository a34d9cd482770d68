"""Copy of `codegraph_tpu/search/cache.py` for the PyTorch port.

Query-result cache with TTL + LRU eviction.

Replaces the reference's SearchCacheManager LFU caches
(crates/codegraph-vector/src/cache.rs:391-458) and the graph-tool LRU
result cache (codegraph-mcp-tools/src/graph_tool_executor.rs:161-189).
Keys hash the query embedding bytes + limit + config, exactly like the
reference's QueryHash (cache.rs:345).
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Any, Optional

import numpy as np


def query_key(
    embedding: np.ndarray, limit: int, extra: str = "", filters=None
) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(np.ascontiguousarray(embedding, np.float32).tobytes())
    h.update(f"|{limit}|{extra}|{filters!r}".encode())
    return h.hexdigest()


class SearchCache:
    def __init__(self, max_size: int = 1024, ttl_s: float = 300.0):
        self.max_size = int(max_size)
        self.ttl_s = float(ttl_s)
        self._data: "OrderedDict[str, tuple[float, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Any]:
        item = self._data.get(key)
        if item is None:
            self.misses += 1
            return None
        ts, value = item
        if time.monotonic() - ts > self.ttl_s:
            del self._data[key]
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key: str, value: Any) -> None:
        self._data[key] = (time.monotonic(), value)
        self._data.move_to_end(key)
        while len(self._data) > self.max_size:
            self._data.popitem(last=False)

    def invalidate(self) -> None:
        """Drop everything — called on index mutation."""
        self._data.clear()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "size": len(self._data),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hit_rate, 4),
        }


__all__ = ["SearchCache", "query_key"]

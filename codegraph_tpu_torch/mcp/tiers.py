"""Copy of `codegraph_tpu/mcp/tiers.py` for the PyTorch port.

Context-aware retrieval limits.

Reference: codegraph-mcp-core/src/context_aware_limits.rs:19-60 —
ContextTier::from_context_window buckets (Small <50k, Medium <150k,
Large <500k, Massive) with per-tier retrieval limits and over-retrieve
multipliers, plus the 52k-token MCP output cap (:8).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

MCP_OUTPUT_TOKEN_CAP = 52_000  # context_aware_limits.rs:8


class ContextTier(str, Enum):
    SMALL = "small"
    MEDIUM = "medium"
    LARGE = "large"
    MASSIVE = "massive"

    @classmethod
    def from_context_window(cls, window: int) -> "ContextTier":
        if window < 50_000:
            return cls.SMALL
        if window < 150_000:
            return cls.MEDIUM
        if window < 500_000:
            return cls.LARGE
        return cls.MASSIVE


@dataclass(frozen=True)
class TierLimits:
    search_limit: int
    graph_depth: int
    over_retrieve: int  # prefetch multiplier before truncation
    max_snippet_chars: int


_LIMITS = {
    ContextTier.SMALL: TierLimits(5, 2, 2, 160),
    ContextTier.MEDIUM: TierLimits(10, 3, 3, 240),
    ContextTier.LARGE: TierLimits(20, 4, 3, 400),
    ContextTier.MASSIVE: TierLimits(40, 5, 4, 800),
}


def tier_limits(tier: ContextTier) -> TierLimits:
    return _LIMITS[tier]


__all__ = ["ContextTier", "TierLimits", "tier_limits", "MCP_OUTPUT_TOKEN_CAP"]

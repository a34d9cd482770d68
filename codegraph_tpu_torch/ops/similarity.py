"""Similarity primitives, ported from `codegraph_tpu/ops/similarity.py`.

Cosine over pre-normalized rows == dot product, so the index layer
normalizes at ingest and the hot path is pure dot.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """Row-normalize as `x * rsqrt(max(sum(x^2), eps))` in f32; zero rows
    stay zero. Returns x's dtype."""
    sq = x.float().square().sum(dim=dim, keepdim=True)
    inv = torch.rsqrt(sq.clamp(min=eps))
    return (x * inv).to(x.dtype)


def pairwise_scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[B, D] x [N, D] -> [B, N] dot scores in f32."""
    return q.float() @ x.float().T


__all__ = ["l2_normalize", "pairwise_scores"]

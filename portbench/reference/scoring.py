"""Plain PyTorch scoring of the tiers the configurations state.

A configuration's `scoring` section names the scan's precision and the
rescore's: `{"scan": "int8", "rescore": "bfloat16", "candidates": 100}`
is the int8 tier (an exact top-`max(k, candidates)` by int8 scores, then
the candidates re-ranked by f32 queries against bf16 rows, cut to k);
`{"scan": "bfloat16"}` is the flat tier over bf16 rows, the queries rounded
to bf16 as the rows are. Cosine: rows and queries are L2-normalised first.

Integer precisions are per-row symmetric: a row is `round(x / s)` with
`s = max|x| / levels`, and an integer score is the exact integer dot
product times the query's scale, then the row's. This file imports only
torch.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

#: integer levels of each integer precision
LEVELS = {"int8": 127, "int4": 7}
#: the precision one step below each one a configuration can state
LOWER = {"float32": "bfloat16", "bfloat16": "int8", "int8": "int4"}


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32, not TF32, inside the block."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit length in f32 (zero rows stay zero)."""
    x = x.float()
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True).clamp_min(1e-12))


def quantize(x: torch.Tensor, precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric integers (held in int8) and their f32 scales."""
    levels = float(LEVELS[precision])
    scales = x.abs().amax(-1) / levels
    inv = torch.where(scales > 1e-12, 1.0 / scales.clamp_min(1e-12), torch.zeros_like(scales))
    q = torch.clamp(torch.round(x * inv[:, None]), -levels, levels).to(torch.int8)
    return q, scales


def int_dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """Exact integer dot products [A, B] as f32: summed in f32 while every
    sum fits its 24 bits, else in f64."""
    bound = a.shape[1] * LEVELS[precision] ** 2
    wide = torch.float32 if bound < 2**24 else torch.float64
    return (a.to(wide) @ b.to(wide).T).float()


class Scorer:
    """Scores of normalised queries against blocks of normalised rows held
    in one precision: f32, bf16 or an integer one. With `round_queries`
    (a scan) the queries are held in that precision too; without it (a
    rescore) they stay f32 against the rows as held."""

    def __init__(self, precision: str, queries: torch.Tensor, round_queries: bool = True):
        if precision not in LEVELS and precision not in ("bfloat16", "float32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision
        self.integer = precision in LEVELS and round_queries
        self.queries = queries
        if self.integer:
            self.q_int, self.q_scale = quantize(queries, precision)
        elif precision == "bfloat16" and round_queries:
            self.queries = queries.bfloat16().float()

    def rows(self, x: torch.Tensor):
        """The rows as this precision holds them."""
        if self.precision in LEVELS:
            return quantize(x, self.precision)
        if self.precision == "bfloat16":
            return x.bfloat16()
        return x

    def _wide_rows(self, held, dtype) -> torch.Tensor:
        if self.precision in LEVELS:
            x, xs = held
            return x.to(dtype) * xs.to(dtype)[:, None]
        return held.to(dtype)

    def block(self, held, rows_of=None) -> torch.Tensor:
        """[queries, rows] scores of held rows (as `rows` returns them);
        `rows_of` limits the queries to those indices."""
        with exact_f32():
            if self.integer:
                q, qs = self.q_int, self.q_scale
                if rows_of is not None:
                    q, qs = q[rows_of], qs[rows_of]
                x, xs = held
                return int_dot(q, x, self.precision) * qs[:, None] * xs[None, :]
            q = self.queries if rows_of is None else self.queries[rows_of]
            return q @ self._wide_rows(held, torch.float32).T

    def pairs(self, held, qi: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        """f64 score of query qi[j] against held row rows[j], for every j."""
        if self.integer:
            x, xs = held
            q = self.q_int[qi].double() * self.q_scale[qi].double()[:, None]
            return (q * (x[rows].double() * xs[rows].double()[:, None])).sum(-1)
        if self.precision in LEVELS:
            x, xs = held
            held_rows = x[rows].double() * xs[rows].double()[:, None]
        else:
            held_rows = held[rows].double()
        return (self.queries[qi].double() * held_rows).sum(-1)


def merge_top(vals: torch.Tensor, ids: torch.Tensor, block: torch.Tensor, base: int,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k of scores over blocks of rows (ids are global rows)."""
    kb = min(k, block.shape[1])
    v, i = torch.topk(block, kb, dim=1)
    v = torch.cat([vals, v], 1)
    i = torch.cat([ids, i + base], 1)
    top = torch.topk(v, k, dim=1)
    return top.values, torch.gather(i, 1, top.indices)

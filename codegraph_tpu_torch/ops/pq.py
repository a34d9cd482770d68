"""Product quantization: per-subspace k-means codebooks + ADC scan.

Port of `codegraph_tpu/ops/pq.py`, plain PyTorch (the JAX package has no
Pallas kernel here). m subquantizers of 2^nbits centroids each; query
scoring is ADC (asymmetric distance computation): one small product
builds the [m, ksub] dot table, then scoring a row is a gather-sum over
its m uint8 codes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from codegraph_tpu_torch.ops.kmeans import kmeans
from codegraph_tpu_torch.ops.topk import NEG_INF, merge_topk


@dataclass
class PQCodebook:
    centroids: torch.Tensor  # [m, ksub, dsub] f32

    @property
    def m(self) -> int:
        return self.centroids.shape[0]

    @property
    def ksub(self) -> int:
        return self.centroids.shape[1]

    @property
    def dsub(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.m * self.dsub


def pq_train(
    x: torch.Tensor, m: int, nbits: int = 8, n_iters: int = 10, seed: int = 0
) -> PQCodebook:
    """Train m per-subspace codebooks of 2^nbits centroids each, one
    Euclidean k-means per subspace. x: [N, D] with D % m == 0."""
    N, D = x.shape
    assert D % m == 0, f"D={D} not divisible by m={m}"
    ksub = 1 << nbits
    assert N >= ksub, f"need >= {ksub} training rows, got {N}"
    xs = x.float().reshape(N, m, D // m)
    books = [
        kmeans(xs[:, j, :], ksub, n_iters=n_iters, metric="l2",
               tile_n=min(4096, max(8, N)), seed=seed + j)[0]
        for j in range(m)
    ]
    return PQCodebook(centroids=torch.stack(books))


def pq_encode(x: torch.Tensor, centroids: torch.Tensor, tile_n: int = 8_192) -> torch.Tensor:
    """[N, D] -> [N, m] uint8 codes (nearest centroid per subspace by L2,
    as argmin of ||c||^2 - 2 x.c; the lower code wins a tie). Streams over
    row tiles: the [m, tile, ksub] distance block is the working set."""
    N = x.shape[0]
    m, ksub, dsub = centroids.shape
    centroids = centroids.float()
    c_sq = torch.sum(torch.square(centroids), dim=-1)  # [m, ksub]
    out = []
    for base in range(0, N, tile_n):
        xs = x[base: base + tile_n].float().reshape(-1, m, dsub).transpose(0, 1)  # [m, T, dsub]
        dots = torch.bmm(xs, centroids.transpose(1, 2))  # [m, T, ksub]
        dist = c_sq[:, None, :] - 2.0 * dots
        out.append(torch.argmin(dist, dim=-1).T.to(torch.uint8))
    if not out:
        return torch.zeros((0, m), dtype=torch.uint8, device=x.device)
    return torch.cat(out)


def pq_decode(codes: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[N, m] uint8 -> [N, D] f32 reconstruction."""
    m = centroids.shape[0]
    sub = torch.arange(m, device=codes.device)[None, :]
    return centroids.float()[sub, codes.long()].reshape(codes.shape[0], -1)


def pq_adc_topk(
    q: torch.Tensor,          # [B, D] f32 queries
    codes: torch.Tensor,      # [N, m] uint8 corpus codes
    centroids: torch.Tensor,  # [m, ksub, dsub]
    bias: torch.Tensor,       # [N] f32 (0 live / NEG_INF dead)
    k: int,
    tile_n: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADC dot-product top-k over a flat code matrix (any N):
    score[b, n] = sum_j table[b, j, codes[n, j]] + bias[n] with
    table[b, j, :] = q_sub[b, j] . centroids[j]. Streams over N in tiles."""
    B, D = q.shape
    N, m = codes.shape
    dsub = centroids.shape[2]
    table = torch.einsum("bmd,mkd->bmk", q.float().reshape(B, m, dsub), centroids.float())
    top_s = torch.full((B, k), NEG_INF, dtype=torch.float32, device=q.device)
    top_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    sub = torch.arange(m, device=q.device)
    for base in range(0, N, tile_n):
        ct = codes[base: base + tile_n].long()                  # [T, m]
        s = table[:, sub[None, :], ct].sum(dim=-1) + bias[base: base + tile_n][None, :]
        ids = torch.arange(base, base + ct.shape[0], dtype=torch.int32,
                           device=q.device).expand(B, -1)
        top_s, top_i = merge_topk(top_s, top_i, s, ids, k)
    return top_s, top_i


__all__ = ["PQCodebook", "pq_train", "pq_encode", "pq_decode", "pq_adc_topk"]

"""Batched k-means (Lloyd's) for the IVF index build and PQ training.

Port of `codegraph_tpu/ops/kmeans.py`. Plain PyTorch: the JAX package
computes this work outside any Pallas kernel, as matrix products per row
tile. Assignment is `scores = x_tile @ c.T` + argmax; the centroid update
sums `onehot(assign).T @ x_tile`, so the [N, nlist] score matrix never
exists whole. Scores stay in true f32 (a CUDA float32 matmul runs without
TF32 unless the caller turns it on).

Spherical mode (`metric="cosine"`) re-normalizes centroids every
iteration (argmax dot == nearest on the sphere). The JAX package draws
its initial centroids with `jax.random`; here they come from a
`torch.Generator` seeded with `seed`, so the two packages start from
different centroids for the same seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _tile_assign(
    x_tile: torch.Tensor, c: torch.Tensor, c_half_sq: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[T, D] x [K, D] -> nearest-centroid assignment [T] int32.

    c_half_sq = ||c||^2 / 2 turns the dot argmax into an L2 argmin
    (argmin ||x-c||^2 == argmax x.c - ||c||^2/2); None keeps plain dot.
    On equal scores the lower centroid index wins.
    """
    scores = x_tile.float() @ c.float().T
    if c_half_sq is not None:
        scores = scores - c_half_sq[None, :]
    return torch.argmax(scores, dim=1).to(torch.int32)


def _half_sq(centroids: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(torch.square(centroids.float()), dim=1)


def assign_clusters(
    x: torch.Tensor, centroids: torch.Tensor, mask: Optional[torch.Tensor] = None,
    tile_n: int = 4096, metric: str = "cosine",
) -> torch.Tensor:
    """Streaming nearest-centroid assignment.

    x: [N, D] (any N); centroids: [K, D]; mask: [N] bool, kept for the
    reference's signature (padding rows are assigned too and ignored by
    the caller). Returns [N] int32 assignments.
    """
    c_half_sq = _half_sq(centroids) if metric == "l2" else None
    out = [_tile_assign(x[base: base + tile_n], centroids, c_half_sq)
           for base in range(0, x.shape[0], tile_n)]
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.int32, device=x.device)


def assign_clusters_topk(
    x: torch.Tensor, centroids: torch.Tensor, mask: Optional[torch.Tensor] = None,
    tile_n: int = 4096, metric: str = "cosine", top: int = 2,
) -> torch.Tensor:
    """Top-`top` nearest centroids per row ([N, top] int32): the spill
    targets for capacity-bounded IVF cells."""
    c_half_sq = _half_sq(centroids) if metric == "l2" else None
    out = []
    for base in range(0, x.shape[0], tile_n):
        scores = x[base: base + tile_n].float() @ centroids.float().T
        if c_half_sq is not None:
            scores = scores - c_half_sq[None, :]
        out.append(torch.topk(scores, top, dim=1).indices.to(torch.int32))
    if not out:
        return torch.zeros((0, top), dtype=torch.int32, device=x.device)
    return torch.cat(out)


def _lloyd_iteration(
    x: torch.Tensor,
    maskf: torch.Tensor,
    centroids: torch.Tensor,
    n_clusters: int,
    tile_n: int,
    spherical: bool,
    l2: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Lloyd's step over x [N, D] (any N), rows weighted by maskf [N].
    Returns (new_centroids [K, D] f32, counts [K] f32)."""
    D = x.shape[1]
    centroids = centroids.float()
    c_half_sq = _half_sq(centroids) if l2 else None
    sums = torch.zeros((n_clusters, D), dtype=torch.float32, device=x.device)
    counts = torch.zeros((n_clusters,), dtype=torch.float32, device=x.device)
    for base in range(0, x.shape[0], tile_n):
        xt = x[base: base + tile_n].float()
        assign = _tile_assign(xt, centroids, c_half_sq).long()
        onehot = torch.nn.functional.one_hot(assign, n_clusters).float()
        onehot = onehot * maskf[base: base + tile_n, None].float()
        sums = sums + onehot.T @ xt
        counts = counts + onehot.sum(dim=0)
    # empty clusters keep their previous centroid
    safe = torch.clamp(counts, min=1.0)[:, None]
    new_c = torch.where(counts[:, None] > 0, sums / safe, centroids)
    if spherical:
        sq = torch.sum(torch.square(new_c), dim=1, keepdim=True)
        new_c = new_c * torch.rsqrt(torch.clamp(sq, min=1e-12))
    return new_c, counts


def initial_centroids(
    x: torch.Tensor, n_clusters: int, seed: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """n_clusters distinct live rows of x (f32), drawn with a CPU
    torch.Generator seeded with `seed`."""
    maskf = (torch.ones(x.shape[0]) if mask is None else mask.detach().cpu().float())
    probs = maskf / torch.clamp(maskf.sum(), min=1.0)
    gen = torch.Generator().manual_seed(int(seed))
    rows = torch.multinomial(probs, n_clusters, replacement=False, generator=gen)
    return x[rows.to(x.device)].float()


def kmeans(
    x: torch.Tensor,
    n_clusters: int,
    n_iters: int = 10,
    metric: str = "cosine",
    tile_n: int = 4096,
    seed: int = 0,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Lloyd's k-means on x's device.

    x: [N, D]; mask: [N] bool (False = padding). Returns (centroids
    [n_clusters, D] f32, counts [n_clusters] f32). Initialization samples
    live rows without replacement (`initial_centroids`).
    """
    maskf = (torch.ones(x.shape[0], device=x.device) if mask is None
             else mask.to(x.device).float())
    centroids = initial_centroids(x, n_clusters, seed, mask)
    if metric == "cosine":
        sq = torch.sum(torch.square(centroids), dim=1, keepdim=True)
        centroids = centroids * torch.rsqrt(torch.clamp(sq, min=1e-12))
    counts = torch.zeros((n_clusters,), dtype=torch.float32, device=x.device)
    for _ in range(n_iters):
        centroids, counts = _lloyd_iteration(
            x, maskf, centroids, n_clusters, tile_n, metric == "cosine", metric == "l2")
    return centroids, counts


__all__ = ["kmeans", "assign_clusters", "assign_clusters_topk", "initial_centroids"]

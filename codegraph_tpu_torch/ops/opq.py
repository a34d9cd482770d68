"""OPQ: learned orthogonal rotation before product quantization.

Port of `codegraph_tpu/ops/opq.py`, plain PyTorch. OPQ (Ge et al.,
CVPR'13) learns an orthogonal R minimizing ||X R - decode(encode(X R))||^2
by alternating PQ training with an orthogonal-Procrustes solve; because R
is orthogonal it preserves every dot product, so the IVF-PQ index applies
it as a global pre-rotation of the whole space.

`pq_train_batched` runs the m subspace k-means as one Lloyd's program
over a batch dimension [m, N, dsub] (the JAX package's vmap, written
out). Its initial rows come from a CPU `torch.Generator` seeded with
`seed`, not from `jax.random`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from codegraph_tpu_torch.ops.pq import PQCodebook, pq_decode, pq_encode


def _subspace_lloyd(
    xs: torch.Tensor,      # [m, N, dsub] f32
    init_c: torch.Tensor,  # [m, ksub, dsub] f32
    ksub: int,
    n_iters: int,
    tile_n: int,
) -> torch.Tensor:
    """Lloyd's over all m subspaces at once (L2 metric). Returns
    [m, ksub, dsub] centroids; empty clusters keep their previous
    centroid."""
    m, N, dsub = xs.shape
    c = init_c.float()
    for _ in range(n_iters):
        c_half_sq = 0.5 * torch.sum(torch.square(c), dim=-1)  # [m, ksub]
        sums = torch.zeros((m, ksub, dsub), dtype=torch.float32, device=xs.device)
        counts = torch.zeros((m, ksub), dtype=torch.float32, device=xs.device)
        for base in range(0, N, tile_n):
            xt = xs[:, base: base + tile_n]                            # [m, T, dsub]
            scores = torch.bmm(xt, c.transpose(1, 2)) - c_half_sq[:, None, :]
            onehot = torch.nn.functional.one_hot(scores.argmax(dim=-1), ksub).float()
            sums = sums + torch.bmm(onehot.transpose(1, 2), xt)        # [m, ksub, dsub]
            counts = counts + onehot.sum(dim=1)
        safe = torch.clamp(counts, min=1.0)[:, :, None]
        c = torch.where(counts[:, :, None] > 0, sums / safe, c)
    return c


def pq_train_batched(
    x: torch.Tensor, m: int, nbits: int = 8, n_iters: int = 10, seed: int = 0,
    tile_n: int = 4096,
) -> PQCodebook:
    """Train m subspace codebooks with one batched Lloyd's program (L2
    subspace k-means, row-sample init). x: [N, D], D % m == 0. As in the
    reference, N is padded to a multiple of tile_n with copies of row 0."""
    N, D = x.shape
    assert D % m == 0, f"D={D} not divisible by m={m}"
    ksub = 1 << nbits
    assert N >= ksub, f"need >= {ksub} training rows, got {N}"
    dsub = D // m
    xs = x.float().reshape(N, m, dsub).transpose(0, 1)           # [m, N, dsub]
    gen = torch.Generator().manual_seed(int(seed))
    rows = torch.randint(0, N, (m, ksub), generator=gen).to(x.device)
    init_c = torch.gather(xs, 1, rows[:, :, None].expand(m, ksub, dsub))
    pad = (-N) % tile_n
    if pad:
        xs = torch.cat([xs, xs[:, :1].expand(m, pad, dsub)], dim=1)
    return PQCodebook(centroids=_subspace_lloyd(xs.contiguous(), init_c, ksub, n_iters, tile_n))


def opq_train(
    x: torch.Tensor,
    m: int,
    nbits: int = 8,
    n_iters: int = 6,
    pq_iters: int = 3,
    final_pq_iters: int = 10,
    seed: int = 0,
) -> Tuple[torch.Tensor, PQCodebook]:
    """Alternating OPQ-NP: (train PQ on X R) <-> (Procrustes R update).

    x: [N, D] training rows (typically IVF residuals). Returns (rot [D, D],
    books): apply as `x @ rot` before encoding. Each outer iteration trains
    light codebooks on the rotated data, reconstructs, and solves
    min_R ||X R - Xhat||_F s.t. R^T R = I via the SVD of X^T Xhat
    (R = U V^T); the final codebooks get final_pq_iters Lloyd steps.
    """
    D = x.shape[1]
    x = x.float()
    rot = torch.eye(D, dtype=torch.float32, device=x.device)
    for it in range(n_iters):
        xr = x @ rot
        books = pq_train_batched(xr, m, nbits=nbits, n_iters=pq_iters, seed=seed + it)
        xhat = pq_decode(pq_encode(xr, books.centroids), books.centroids)
        u, _, vt = torch.linalg.svd(x.T @ xhat, full_matrices=False)
        rot = u @ vt
    books = pq_train_batched(x @ rot, m, nbits=nbits, n_iters=final_pq_iters, seed=seed)
    return rot, books


def pq_distortion(x: torch.Tensor, books: PQCodebook) -> float:
    """Mean squared reconstruction error, the quantity OPQ minimizes."""
    xhat = pq_decode(pq_encode(x, books.centroids), books.centroids)
    return float(torch.mean(torch.sum(torch.square(x.float() - xhat), dim=1)))


__all__ = ["opq_train", "pq_train_batched", "pq_distortion"]

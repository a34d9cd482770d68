"""The port's product quantization (`ops/pq.py`, `ops/opq.py`) held to the
JAX package on the CPU.

Inputs are numpy arrays from a seed, handed to both packages. Codebook
initialization draws from `jax.random` in the reference, which torch
cannot reproduce, so the Lloyd's programs are compared from the same
initial centroids and the trainers by the quality they reach.

Tolerances:
* codes from `pq_encode`: equal except where two centroids are at equal
  distance within f32 rounding (the two packages sum the products in
  another order); at most 1 in 1,000 codes may differ, and only by such a
  near-tie;
* decodes, codebooks from the same initial centroids, distortions and ADC
  scores: within 1e-5 absolute (1e-4 relative for distortions);
* trained quality: the port's distortion within 10% of the JAX package's
  on the same data (different random starts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.ops import opq as jopq
from codegraph_tpu.ops import pq as jpq
from codegraph_tpu_torch.ops import opq as topq
from codegraph_tpu_torch.ops import pq as tpq

from tests.test_torch_topk import assert_topk_equiv

TOL = 1e-5


def _data(rng, n, d, aniso=False):
    x = rng.standard_normal((n, d)).astype(np.float32)
    if aniso:  # variance concentrated in a few directions, as IVF residuals
        x *= np.linspace(3.0, 0.1, d, dtype=np.float32)[None, :]
        x = x @ np.linalg.qr(rng.standard_normal((d, d)))[0].astype(np.float32)
    return x.astype(np.float32)


def _books(rng, m, ksub, dsub):
    return rng.standard_normal((m, ksub, dsub)).astype(np.float32)


@pytest.mark.parametrize("m,ksub,dsub,n", [(8, 256, 4, 700), (4, 16, 8, 300), (12, 32, 2, 257)])
def test_pq_encode_decode_match_jax(rng, m, ksub, dsub, n):
    books = _books(rng, m, ksub, dsub)
    x = _data(rng, n, m * dsub)
    jc = np.asarray(jpq.pq_encode(jnp.asarray(x), jnp.asarray(books), tile_n=128))
    tc = tpq.pq_encode(torch.from_numpy(x), torch.from_numpy(books), tile_n=100)
    assert tc.dtype == torch.uint8 and tc.shape == (n, m)
    diff = tc.numpy() != jc
    assert diff.mean() <= 1e-3
    for r, j in zip(*np.nonzero(diff)):  # a near-tie of two centroids
        sub = x[r, j * dsub:(j + 1) * dsub]
        d = ((books[j] - sub) ** 2).sum(axis=1)
        assert abs(d[tc[r, j]] - d[jc[r, j]]) <= 1e-4 * max(1.0, d.min())
    np.testing.assert_allclose(tpq.pq_decode(torch.from_numpy(jc.copy()), torch.from_numpy(books)).numpy(),
                               np.asarray(jpq.pq_decode(jnp.asarray(jc), jnp.asarray(books))),
                               rtol=0, atol=0)


@pytest.mark.parametrize("tile", [128, 512])
def test_subspace_lloyd_matches_jax(rng, tile):
    m, ksub, dsub, n = 6, 16, 4, 512
    x = _data(rng, n, m * dsub)
    xs = np.ascontiguousarray(np.swapaxes(x.reshape(n, m, dsub), 0, 1))
    init = xs[:, rng.choice(n, ksub, replace=False)]
    want = np.asarray(jopq._subspace_lloyd(jnp.asarray(xs), jnp.asarray(init), ksub, 5, tile))
    got = topq._subspace_lloyd(torch.from_numpy(xs), torch.from_numpy(init), ksub, 5, tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_pq_distortion_matches_jax_on_the_same_books(rng):
    books = _books(rng, 8, 32, 4)
    x = _data(rng, 400, 32)
    want = jopq.pq_distortion(jnp.asarray(x), jpq.PQCodebook(jnp.asarray(books)))
    got = topq.pq_distortion(torch.from_numpy(x), tpq.PQCodebook(torch.from_numpy(books)))
    assert got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("trainer", ["batched", "sequential"])
def test_pq_training_quality_matches_jax(rng, trainer):
    x = _data(rng, 1024, 32, aniso=True)
    if trainer == "batched":
        jb = jopq.pq_train_batched(jnp.asarray(x), 8, nbits=5, n_iters=8, seed=1, tile_n=512)
        tb = topq.pq_train_batched(torch.from_numpy(x), 8, nbits=5, n_iters=8, seed=1, tile_n=512)
    else:
        jb = jpq.pq_train(jnp.asarray(x), 8, nbits=5, n_iters=8, seed=1)
        tb = tpq.pq_train(torch.from_numpy(x), 8, nbits=5, n_iters=8, seed=1)
    assert tb.centroids.shape == (8, 32, 4) and (tb.m, tb.ksub, tb.dsub, tb.dim) == (8, 32, 4, 32)
    dj = jopq.pq_distortion(jnp.asarray(x), jb)
    dt = topq.pq_distortion(torch.from_numpy(x), tb)
    assert dt <= 1.1 * dj
    assert dt < 0.5 * float(np.mean(np.sum(x ** 2, axis=1)))  # far better than no code at all


def test_pq_train_batched_pads_with_row_zero_like_jax(rng):
    """N not a multiple of tile_n: both packages pad with copies of row 0,
    which count in the first subspace cluster; from the same start the
    codebooks agree."""
    m, ksub, dsub, n, tile = 4, 8, 4, 200, 128
    x = _data(rng, n, m * dsub)
    xs = np.swapaxes(x.reshape(n, m, dsub), 0, 1)
    padded = np.concatenate([xs, np.repeat(xs[:, :1], (-n) % tile, axis=1)], axis=1)
    init = xs[:, :ksub]
    want = np.asarray(jopq._subspace_lloyd(jnp.asarray(padded), jnp.asarray(init), ksub, 3, tile))
    got = topq._subspace_lloyd(
        torch.cat([torch.from_numpy(np.ascontiguousarray(xs)),
                   torch.from_numpy(np.ascontiguousarray(xs[:, :1])).expand(m, (-n) % tile, dsub)],
                  dim=1), torch.from_numpy(np.ascontiguousarray(init)), ksub, 3, tile)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_opq_rotation_is_orthogonal_and_scores_match_jax(rng):
    """OPQ on anisotropic data: the port's rotation is orthogonal, lowers the
    distortion below plain PQ's, and reaches the JAX package's within 10%;
    with one rotation and codebook set, both packages' distortions agree."""
    x = _data(rng, 1024, 32, aniso=True)
    rot, books = topq.opq_train(torch.from_numpy(x), 8, nbits=4, n_iters=3, pq_iters=2,
                                final_pq_iters=6, seed=0)
    np.testing.assert_allclose((rot.T @ rot).numpy(), np.eye(32), rtol=0, atol=1e-4)
    xr = torch.from_numpy(x) @ rot
    d_opq = topq.pq_distortion(xr, books)
    d_pq = topq.pq_distortion(torch.from_numpy(x), topq.pq_train_batched(
        torch.from_numpy(x), 8, nbits=4, n_iters=6, seed=0))
    assert d_opq < d_pq
    jrot, jbooks = jopq.opq_train(jnp.asarray(x), 8, nbits=4, n_iters=3, pq_iters=2,
                                  final_pq_iters=6, seed=0)
    d_jax = jopq.pq_distortion(jnp.asarray(x) @ jrot, jbooks)
    assert d_opq <= 1.1 * d_jax
    same = jopq.pq_distortion(jnp.asarray(xr.numpy()), jpq.PQCodebook(jnp.asarray(books.centroids.numpy())))
    assert d_opq == pytest.approx(same, rel=1e-4)


@pytest.mark.parametrize("B,N,k,tile", [(3, 512, 10, 128), (5, 300, 40, 256)])
def test_pq_adc_topk_matches_jax(rng, B, N, k, tile):
    m, ksub, dsub = 8, 16, 4
    books = 0.3 * _books(rng, m, ksub, dsub)  # scores of order 1
    codes = rng.integers(0, ksub, (N, m)).astype(np.uint8)
    codes[7] = codes[3]  # an exact tie
    bias = np.zeros(N, np.float32)
    bias[rng.choice(N, 5, replace=False)] = -1e30
    q = _data(rng, B, m * dsub)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    n_pad = -(-N // tile) * tile  # the JAX scan takes whole tiles
    cp = np.zeros((n_pad, m), np.uint8)
    cp[:N] = codes
    bp = np.full(n_pad, -1e30, np.float32)
    bp[:N] = bias
    js, ji = jpq.pq_adc_topk(jnp.asarray(q), jnp.asarray(cp), jnp.asarray(books),
                             jnp.asarray(bp), k, tile_n=tile)
    ts, ti = tpq.pq_adc_topk(torch.from_numpy(q), torch.from_numpy(codes), torch.from_numpy(books),
                             torch.from_numpy(bias), k, tile_n=100)
    dec = tpq.pq_decode(torch.from_numpy(codes), torch.from_numpy(books)).numpy()
    assert_topk_equiv(ts, ti, js, ji, q, dec, bias)

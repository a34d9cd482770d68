"""The port's k-means (`codegraph_tpu_torch.ops.kmeans`) held to the JAX
package on the CPU.

The inputs are made with numpy from a seed and handed to both packages.
The JAX package draws its initial centroids with `jax.random`, which torch
cannot reproduce, so the comparisons start both sides from the same
centroids: `_lloyd_iteration` step by step, and `kmeans` (its initial
draw replaced by the same rows) against the JAX iteration repeated. Tolerances: centroids within 1e-5 absolute
(f32 sums of a few hundred unit-scale rows taken in another order; the
one-hot products and the argmax are the reference's), counts and
assignments equal (the seeded data has no near-ties). The port's own
initialization is held to what k-means must give: every centroid a live
row at the start, and the clusters of well-separated data recovered.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# both packages' ops/__init__ export the function `kmeans`, which hides the
# submodule of the same name from `from ... import`
jkm = importlib.import_module("codegraph_tpu.ops.kmeans")
tkm = importlib.import_module("codegraph_tpu_torch.ops.kmeans")

TOL = 1e-5


def _blobs(rng, n, d, k, spread=0.15):
    centers = rng.standard_normal((k, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    labels = rng.integers(0, k, n)
    x = centers[labels] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return x.astype(np.float32), labels, centers


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("spherical,l2", [(True, False), (False, True), (False, False)])
@pytest.mark.parametrize("n,tile", [(512, 128), (300, 300)])
def test_lloyd_iteration_matches_jax(rng, spherical, l2, n, tile):
    x, _, _ = _blobs(rng, n, 24, 6)
    if spherical:
        x = _unit(x)
    mask = np.ones(n, np.float32)
    mask[-7:] = 0.0  # masked rows count for nothing
    c0 = x[rng.choice(n, 6, replace=False)]
    jc, jn = jkm._lloyd_iteration(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(c0), 6, tile,
                                  spherical, l2)
    tc, tn = tkm._lloyd_iteration(torch.from_numpy(x), torch.from_numpy(mask),
                                  torch.from_numpy(c0), 6, tile, spherical, l2)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)


def test_lloyd_iteration_ragged_tiles_and_empty_cluster(rng):
    """Any N (the JAX step needs N % tile_n == 0: its input is padded with
    masked rows); an empty cluster keeps its centroid."""
    x, _, _ = _blobs(rng, 301, 16, 4)
    c0 = np.concatenate([x[:3], np.full((1, 16), 50.0, np.float32)])  # the far one stays empty
    pad = np.zeros((384 - 301, 16), np.float32)
    mask = np.concatenate([np.ones(301, np.float32), np.zeros(384 - 301, np.float32)])
    jc, jn = jkm._lloyd_iteration(jnp.asarray(np.concatenate([x, pad])), jnp.asarray(mask),
                                  jnp.asarray(c0), 4, 128, False, True)
    tc, tn = tkm._lloyd_iteration(torch.from_numpy(x), torch.ones(301), torch.from_numpy(c0), 4,
                                  128, False, True)
    assert tn[3] == 0 and np.array_equal(tc[3].numpy(), c0[3])
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=TOL)


@pytest.mark.parametrize("metric", ["cosine", "dot", "l2"])
def test_assign_clusters_matches_jax(rng, metric):
    x, _, _ = _blobs(rng, 512, 32, 8)
    c = rng.standard_normal((8, 32)).astype(np.float32)
    mask = np.ones(512, bool)
    want = np.asarray(jkm.assign_clusters(jnp.asarray(x), jnp.asarray(c), jnp.asarray(mask),
                                          tile_n=128, metric=metric))
    got = tkm.assign_clusters(torch.from_numpy(x), torch.from_numpy(c), None, tile_n=100,
                              metric=metric)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric,top", [("cosine", 2), ("l2", 3), ("dot", 1)])
def test_assign_clusters_topk_matches_jax(rng, metric, top):
    x, _, _ = _blobs(rng, 256, 32, 8)
    c = rng.standard_normal((8, 32)).astype(np.float32)
    want = np.asarray(jkm.assign_clusters_topk(jnp.asarray(x), jnp.asarray(c),
                                               jnp.ones(256, bool), tile_n=64, metric=metric,
                                               top=top))
    got = tkm.assign_clusters_topk(torch.from_numpy(x), torch.from_numpy(c), None, tile_n=64,
                                   metric=metric, top=top)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_kmeans_from_same_init_matches_jax_iterations(rng, monkeypatch, metric):
    x, _, _ = _blobs(rng, 512, 16, 5)
    c0 = x[rng.choice(512, 5, replace=False)]
    # the initial rows both packages start from, in place of the port's draw
    monkeypatch.setattr(tkm, "initial_centroids", lambda *a, **k: torch.from_numpy(c0))
    cj = jnp.asarray(c0)
    if metric == "cosine":
        cj = cj / jnp.linalg.norm(cj, axis=1, keepdims=True)
    for _ in range(4):
        cj, nj = jkm._lloyd_iteration(jnp.asarray(x), jnp.ones(512), cj, 5, 128,
                                      metric == "cosine", metric == "l2")
    ct, nt = tkm.kmeans(torch.from_numpy(x), 5, n_iters=4, metric=metric, tile_n=128)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=TOL)


def test_kmeans_own_init_recovers_clusters(rng):
    """As tests/test_ivf_index.py holds the JAX k-means: 4 separated blobs."""
    x, labels, centers = _blobs(rng, 400, 32, 4, spread=0.05)
    x = _unit(x)
    c, counts = tkm.kmeans(torch.from_numpy(x), 4, n_iters=10, metric="cosine", tile_n=128,
                           seed=3)
    assert float(counts.sum()) == 400
    sim = c.numpy() @ centers.T
    assert sorted(np.argmax(sim, axis=1).tolist()) == [0, 1, 2, 3]
    assert (sim.max(axis=1) > 0.95).all()


def test_initial_centroids_are_distinct_live_rows(rng):
    x = rng.standard_normal((50, 8)).astype(np.float32)
    mask = torch.zeros(50, dtype=torch.bool)
    mask[:20] = True
    c = tkm.initial_centroids(torch.from_numpy(x), 10, seed=5, mask=mask)
    rows = {int(np.argmin(np.abs(x - r).sum(axis=1))) for r in c.numpy()}
    assert len(rows) == 10 and max(rows) < 20
    again = tkm.initial_centroids(torch.from_numpy(x), 10, seed=5, mask=mask)
    assert torch.equal(c, again)

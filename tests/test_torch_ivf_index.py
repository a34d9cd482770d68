"""The port's IVFIndex held to the JAX package's IVFIndex on the CPU.

State is carried over with `IVFIndex.load_arrays` (the JAX index's arrays,
fill and counters), because the two packages' k-means start from
different random centroids. On identical state:
* searches: scores within 1e-5 (f32 dot products of unit rows summed in
  another order), ids equal except where the scores tie within that bound;
* `add` after the carried state: the same (cell, pos) for every row, the
  same fill, cell capacity and stored rows (within 1e-6: the last bit of
  the f32 norm may differ), including a corpus whose cells overflow and
  spill to second and third choices;
* the reference behaviour of a `_fill` longer than `nlist` (the indexer's
  tiny-corpus shrink): rows placed in a cell >= nlist are recorded and not
  stored, in both packages.
The port's own training is held to the JAX package's recall@10 within
0.05 on the same clustered data.
"""

import numpy as np
import pytest
import torch

from codegraph_tpu.index.ivf import IVFIndex as JIVF
from codegraph_tpu_torch.core.errors import IndexNotBuilt
from codegraph_tpu_torch.index import ivf as tivf
from codegraph_tpu_torch.index.ivf import IVFIndex as TIVF

from tests.test_torch_topk import assert_topk_equiv

D = 32


def _clustered(rng, n, k=12, spread=0.3, centers=None):
    centers = rng.standard_normal((k, D)) if centers is None else centers
    x = centers[rng.integers(0, len(centers), n)] + spread * rng.standard_normal((n, D))
    return x.astype(np.float32), centers


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _carried(j, **kw):
    """The port's IVFIndex holding exactly the JAX index's state."""
    t = TIVF(j.dim, nlist=j.nlist, nprobe=j.nprobe, capacity_factor=j.capacity_factor,
             device="cpu", **kw)
    c, x, ids, bias = j.arrays()
    t.load_arrays(np.asarray(c), np.asarray(x, np.float32), np.asarray(ids), np.asarray(bias),
                  j._fill, j.list_cap, j.n_rows, j.n_live)
    return t


def _judge(t, q):
    """[B, n_rows] true scores (dot of the stored rows, -1e30 if dead)."""
    c, x, ids, bias = (a.numpy() for a in t.arrays())
    true = np.full((q.shape[0], t.n_rows), -1e30)
    live = ids >= 0
    true[:, ids[live]] = _unit(q).astype(np.float64) @ x[live].astype(np.float64).T + bias[live]
    return true


def _same_search(j, t, q, k, **kw):
    js, ji = j.search(q, k, **kw)
    ts, ti = t.search(q, k, **kw)
    assert ts.shape == (q.shape[0], k) and ti.dtype == np.int32
    assert_topk_equiv(ts, ti, js, ji, None, None, None, true=_judge(t, q))


@pytest.fixture
def trained(rng):
    x, centers = _clustered(rng, 900)
    j = JIVF(D, nlist=16, nprobe=4, kmeans_iters=5)
    j.train(x)
    j.add(x)
    j.delete(np.arange(0, 900, 41))
    return j, x, centers


@pytest.mark.parametrize("B,nprobe", [(1, None), (7, 2), (40, 16)])
def test_search_on_jax_state_matches_jax(rng, trained, B, nprobe):
    j, x, _ = trained
    t = _carried(j)
    q = x[rng.choice(900, B)] + 0.05 * rng.standard_normal((B, D)).astype(np.float32)
    _same_search(j, t, q, 10, nprobe=nprobe)
    assert t.stats() == j.stats()


def test_full_probe_is_exact(rng, trained):
    j, x, _ = trained
    t = _carried(j)
    q = rng.standard_normal((5, D)).astype(np.float32)
    s, i = t.search(q, 10, nprobe=16)
    true = _judge(t, q)
    want = -np.sort(-true, axis=1)[:, :10]
    np.testing.assert_allclose(s, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("capacity_factor", [2.0, 1.05])
def test_add_delete_search_match_jax(rng, capacity_factor):
    """Chunked adds after the carried training, with cells that overflow at
    capacity factor 1.05 (second- and third-choice spills, growth)."""
    x, centers = _clustered(rng, 600)
    j = JIVF(D, nlist=8, nprobe=3, kmeans_iters=4, capacity_factor=capacity_factor)
    j.train(x)
    t = TIVF(D, nlist=8, nprobe=3, capacity_factor=capacity_factor, device="cpu")
    t._centroids = torch.from_numpy(np.asarray(j._centroids).copy())
    for lo, hi in ((0, 250), (250, 600)):
        assert np.array_equal(j.add(x[lo:hi]), t.add(x[lo:hi]))
    extra, _ = _clustered(rng, 200, centers=centers[:2])  # crowd two cells
    j.add(extra)
    t.add(extra)
    assert j.list_cap == t.list_cap and np.array_equal(j._fill, t._fill)
    assert all(j._row_loc[r] == tuple(t._row_loc[r]) for r in range(j.n_rows))
    jx, tx = np.asarray(j.arrays()[1]), t.arrays()[1].numpy()
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t.arrays()[2].numpy(), np.asarray(j.arrays()[2]))
    dead = rng.choice(800, 60, replace=False)
    j.delete(dead)
    t.delete(dead)
    assert len(t) == len(j) == 740
    np.testing.assert_array_equal(t.arrays()[3].numpy(), np.asarray(j.arrays()[3]))
    q = x[:9] + 0.05 * rng.standard_normal((9, D)).astype(np.float32)
    _same_search(j, t, q, 15)
    if capacity_factor < 2:
        assert j.stats()["max_fill"] == j.list_cap  # the spill path ran


def test_spill_assignment_rules():
    """The plain loop's rules on a hand-made case: cap 2, three cells."""
    fill = np.array([2, 1, 0], np.int64)
    top2 = np.array([[0, 1], [0, 1], [0, 1], [1, 0]], np.int32)
    cells, pos = tivf.spill_assign(top2, fill, 2)
    # row 0: cell 0 full -> second choice 1; rows 1-2: both full -> least
    # filled (2); row 3: both full, all fills equal -> the lowest index
    assert cells.tolist() == [1, 2, 2, 0] and pos.tolist() == [1, 0, 1, 2]
    assert fill.tolist() == [3, 2, 2]


@pytest.mark.parametrize("B", [3, 300])
def test_batch_search_matches_jax_and_search(rng, trained, B):
    j, x, _ = trained
    t = _carried(j)
    q = x[rng.choice(900, B)]
    js, ji = j.search_batch(q, 10, nprobe=3)
    ts, ti = t.search_batch(q, 10, nprobe=3)
    assert_topk_equiv(ts, ti, js, ji, None, None, None, true=_judge(t, q))
    ss, si = t.search(q, 10, nprobe=3)
    assert_topk_equiv(ts, ti, ss, si, None, None, None, true=_judge(t, q))


def test_own_training_recall_close_to_jax(rng):
    x, centers = _clustered(rng, 1500, k=24, spread=0.25)
    q, _ = _clustered(rng, 60, centers=centers, spread=0.25)
    exact = np.argsort(-(_unit(q) @ _unit(x).T), axis=1)[:, :10]

    def recall(idx):
        idx.train(x)
        idx.add(x)
        _, got = idx.search(q, 10)
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, exact)])

    r_j = recall(JIVF(D, nlist=24, nprobe=4, kmeans_iters=8))
    r_t = recall(TIVF(D, nlist=24, nprobe=4, kmeans_iters=8, device="cpu"))
    assert r_t >= r_j - 0.05 and r_t > 0.6


def test_fill_longer_than_nlist_like_jax(rng):
    """The indexer shrinks nlist on a tiny corpus after the index was made;
    _fill keeps its length. A third-choice spill then lands in a cell >=
    nlist: the JAX scatter drops the row, and so does the port, without
    an error; its delete only counts."""
    x, _ = _clustered(rng, 400, k=3, spread=0.1)
    j = JIVF(D, nlist=64, nprobe=4, kmeans_iters=4, capacity_factor=1.0)
    t = TIVF(D, nlist=64, nprobe=4, capacity_factor=1.0, device="cpu")
    for idx in (j, t):
        idx.nlist = 4
    j.train(x)
    t._centroids = torch.from_numpy(np.asarray(j._centroids).copy())
    j.add(x)
    t.add(x)
    assert len(t._fill) == len(j._fill) == 64 and np.array_equal(t._fill, j._fill)
    phantom = [r for r in range(400) if j._row_loc[r][0] >= 4]
    assert phantom, "the case must reach a cell >= nlist"
    assert all(tuple(t._row_loc[r]) == j._row_loc[r] for r in range(400))
    stored = set(t.arrays()[2].numpy().ravel().tolist()) - {-1}
    assert stored == set(range(400)) - set(phantom)
    assert stored == set(np.asarray(j.arrays()[2]).ravel().tolist()) - {-1}
    j.delete(np.asarray(phantom[:2]))
    t.delete(np.asarray(phantom[:2]))
    assert len(t) == len(j) == 398
    assert t.stats() == j.stats()
    _same_search(j, t, x[:5], 10)


def test_empty_untrained_and_bad_rows(rng):
    t = TIVF(D, nlist=4, device="cpu")
    s, i = t.search(np.ones((2, D), np.float32), 3)
    assert (i == -1).all() and (s <= -1e29).all()
    with pytest.raises(IndexNotBuilt):
        t.add(np.ones((3, D), np.float32))
    with pytest.raises(ValueError):
        t.train(np.ones((3, D), np.float32))  # fewer rows than nlist
    x, _ = _clustered(rng, 100)
    t.train(x)
    t.add(x)
    with pytest.raises(KeyError):
        t.delete(np.array([100]))
    assert len(t) == 100


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TIVF(D, nlist=4)

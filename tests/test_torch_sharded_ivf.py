"""The port's sharded IVF and IVF-PQ indexes (`codegraph_tpu_torch/parallel/
sharded_ivf.py`, `sharded_ivfpq.py`) held to the JAX package's on the CPU.

The JAX index is trained and filled on the 8 CPU devices of
tests/conftest.py; its base index's state is carried into the port's
(`load_arrays`), so the tests compare searches, not k-means. The port's
mesh is `[cpu] * 8`: each shard runs `ivf_search`, or K8's plain version
`ivfpq_search`. Tolerances: scores within 1e-5 (f32 sums in another
order), ids equal but where the true scores (the stored rows' dots, the
ADC sums, or the refine bank's dots) tie within it; dead rows -1. Ties
across shards go to the lower shard, not the lower id, in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.parallel import mesh as jmesh
from codegraph_tpu.parallel import sharded_ivf as jsi
from codegraph_tpu.parallel import sharded_ivfpq as jspq
from codegraph_tpu_torch.ops.topk import NEG_INF
from codegraph_tpu_torch.parallel import mesh as tmesh
from codegraph_tpu_torch.parallel import sharded_ivf as tsi
from codegraph_tpu_torch.parallel import sharded_ivfpq as tspq

from tests.test_torch_ivfpq_index import _adc_judge, _clustered, _exact_judge, _host, _unit
from tests.test_torch_topk import assert_topk_equiv

TOL = 1e-5
D = 32
CPU8 = [torch.device("cpu")] * 8


def meshes():
    return jmesh.make_mesh((8,), ("data",)), tmesh.make_mesh((8,), ("data",), devices=CPU8)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x, _ = _clustered(rng, 1000, d=D, k=16)
    x[500:520] = x[40:60]  # duplicate rows: exact ties
    q = np.concatenate([x[rng.choice(1000, 5, replace=False)] + 0.01,
                        rng.standard_normal((2, D)).astype(np.float32)])
    return x, q


def _ivf_judge(base, q):
    c, x, ids, bias = (a.float().numpy() if a.is_floating_point() else a.numpy()
                       for a in base.arrays())
    true = np.full((q.shape[0], base.n_rows), NEG_INF, np.float64)
    live = ids >= 0
    true[:, ids[live]] = _unit(q).astype(np.float64) @ x[live].astype(np.float64).T + bias[live]
    return true


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_ivf_matches_jax(data, dtype):
    x, q = data
    jm, tm = meshes()
    j = jsi.ShardedIVFIndex(D, jm, nlist=16, nprobe=2, kmeans_iters=4, dtype=dtype)
    j.train(x)
    rows = j.add(x)
    j.delete(rows[::13])
    t = tsi.ShardedIVFIndex(D, tm, nlist=16, nprobe=2, dtype=dtype)
    b = j._base
    c, xl, ids, bias = b.arrays()
    t.load_arrays(np.asarray(c), np.asarray(xl, np.float32), np.asarray(ids), np.asarray(bias),
                  b._fill, b.list_cap, b.n_rows, b.n_live)
    assert len(t) == len(j) and t.stats() == j.stats()
    true = _ivf_judge(t._base, q)
    for nprobe in (None, 1, 2):   # 2 = every local cell: exact
        js, ji = j.search(q, 10, nprobe=nprobe)
        ts, ti = t.search(q, 10, nprobe=nprobe)
        assert ts.shape == (q.shape[0], 10) and ti.dtype == np.int32
        assert_topk_equiv(ts, ti, js, ji, None, None, None, tol=TOL, true=true)
    # a delete after placement reaches the shards
    j.delete(rows[1:3])
    t.delete(rows[1:3])
    js, ji = j.search(x[1:3], 5)
    ts, ti = t.search(x[1:3], 5)
    assert not np.isin(rows[1:3], ti).any()
    assert_topk_equiv(ts, ti, js, ji, None, None, None, tol=TOL, true=_ivf_judge(t._base, x[1:3]))


def test_sharded_ivf_tie_goes_to_the_lower_shard():
    """The same row in cell 2 (shard 2, id 900) and cell 5 (shard 5, id 3):
    both packages put shard 2's id first, the higher id."""
    rng = np.random.default_rng(5)
    cents = _unit(rng.standard_normal((8, D)))
    x = np.zeros((8, 4, D), np.float32)
    ids = np.full((8, 4), -1, np.int32)
    bias = np.full((8, 4), NEG_INF, np.float32)
    v = _unit(rng.standard_normal((1, D)))[0]
    for cell, row in ((2, 900), (5, 3)):
        x[cell, 0], ids[cell, 0], bias[cell, 0] = v, row, 0.0
    q = v[None].copy()
    jm, tm = meshes()
    js, ji = jsi.sharded_ivf_search(*(jnp.asarray(a) for a in (q, cents, x, ids, bias)), 2, 1, jm)
    ts, ti = tsi.sharded_ivf_search(*(torch.from_numpy(a) for a in (q, cents, x, ids, bias)), 2,
                                    1, tm)
    assert np.asarray(ji)[0].tolist() == [900, 3] == ti[0].tolist()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _carry_pq(j, t):
    b = j._base
    c, codes, ids, bias = b.arrays()
    rows = scales = None
    if b._raw_chunks:
        rows, scales = np.concatenate(b._raw_chunks), np.concatenate(b._raw_scales)
    elif b._dev_chunks:
        rows, scales = (np.asarray(a) for a in b._dev_bank())
    t.load_arrays(_host(c), _host(codes), _host(ids), _host(bias), b._fill, b.list_cap, b.n_rows,
                  b.n_live, books=_host(b._books), rot=_host(b._rot), refine_rows=rows,
                  refine_scales=scales)
    return rows, scales


@pytest.mark.parametrize("refine,opq", [("none", False), ("f32", False), ("int8", False),
                                        ("int8_device", False), ("int8_device", True)])
def test_sharded_ivfpq_matches_jax(data, refine, opq):
    x, q = data
    jm, tm = meshes()
    kw = dict(nlist=16, nprobe=2, m=8, refine=refine, refine_factor=4, opq=opq)
    j = jspq.ShardedIVFPQIndex(D, jm, kmeans_iters=4, pq_iters=4, **kw)
    j.train(x)
    rows = j.add(x)
    j.delete(rows[::17])
    t = tspq.ShardedIVFPQIndex(D, tm, **kw)
    bank, scales = _carry_pq(j, t)
    assert t.stats() == j.stats() and t.stats()["shards"] == 8
    base = t._base
    true = _adc_judge(base, q) if refine == "none" else _exact_judge(base, q, bank, scales)
    for nprobe in (None, 1, 2):
        js, ji = j.search(q, 10, nprobe=nprobe)
        ts, ti = t.search(q, 10, nprobe=nprobe)
        assert ts.shape == (q.shape[0], 10) and ti.dtype in (np.int32, np.int64)
        if refine == "none":
            true_m = np.where(true > NEG_INF / 2, true, NEG_INF)
        else:
            dead = np.isin(np.arange(base.n_rows), rows[::17])
            true_m = np.where(dead[None], NEG_INF, true)
        assert_topk_equiv(ts, ti, js, ji, None, None, None, tol=TOL, true=true_m)
    j.delete(rows[1:4])
    t.delete(rows[1:4])
    _, ti = t.search(x[1:4] + 0.001, 5)
    _, ji = j.search(x[1:4] + 0.001, 5)
    assert not np.isin(rows[1:4], ti).any() and not np.isin(rows[1:4], ji).any()


def test_sharded_ivfpq_refined_is_the_exact_int8_rescore(data):
    """The range-sharded refine with its psum: every shard's partial is 0
    outside its bank rows, and the sum is the single index's exact score."""
    x, q = data
    jm, tm = meshes()
    kw = dict(nlist=16, nprobe=2, m=8, refine="int8_device", refine_factor=8)
    j = jspq.ShardedIVFPQIndex(D, jm, kmeans_iters=4, pq_iters=4, **kw)
    j.train(x)
    j.add(x)
    t = tspq.ShardedIVFPQIndex(D, tm, **kw)
    bank, scales = _carry_pq(j, t)
    t._place()
    assert sum(b.shape[0] for b in t._bank) == -(-bank.shape[0] // 8) * 8
    ts, ti = t.search(q, 10)
    qn = torch.from_numpy(_unit(q))
    exact = qn.double() @ (torch.from_numpy(np.array(bank)).double()
                           * torch.from_numpy(np.array(scales))).T
    got = exact.gather(1, torch.from_numpy(ti).long().clamp(min=0)).numpy()
    np.testing.assert_allclose(ts, got, rtol=0, atol=TOL)

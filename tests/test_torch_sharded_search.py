"""The port's corpus-sharded search (`codegraph_tpu_torch/parallel/`) held to
the JAX package's (`codegraph_tpu/parallel/sharded_search.py`) on the CPU.

The JAX side runs on the 8 CPU devices that tests/conftest.py fakes; the
port's on a mesh of `[cpu] * 8` (the plain versions of K1/K2 and K5/K6 run
per shard). Inputs come from numpy seeds. Tolerances: scores within 1e-5
(f32 sums in another order; scores of unit rows lie in [-1, 1]), ids equal
but where the true scores tie (`assert_topk_equiv`), dead rows and padding
(NEG_INF, -1) at the same places. Also the mesh, its collectives against
`jax.lax`'s under shard_map, a tie across shards (the lower shard wins in
both), and HybridSearch over a ShardedFlatIndex.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from codegraph_tpu.parallel import mesh as jmesh
from codegraph_tpu.parallel import sharded_search as jss
from codegraph_tpu_torch.ops.topk import NEG_INF
from codegraph_tpu_torch.parallel import mesh as tmesh
from codegraph_tpu_torch.parallel import sharded_search as tss

from tests.test_torch_topk import assert_topk_equiv

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.experimental.shard_map import shard_map

TOL = 1e-5
CPU8 = [torch.device("cpu")] * 8


def _unit(a):
    n = np.linalg.norm(a, axis=1, keepdims=True)
    return (a / np.maximum(n, 1e-6)).astype(np.float32)


def meshes(shape, axes):
    return jmesh.make_mesh(shape, axes), tmesh.make_mesh(shape, axes, devices=CPU8)


# -- the mesh and its collectives -----------------------------------------


def test_mesh_shapes_and_devices():
    assert tmesh.default_mesh_shape(8, 1) == jmesh.default_mesh_shape(8, 1) == (8,)
    assert tmesh.default_mesh_shape(8, 2) == jmesh.default_mesh_shape(8, 2) == (4, 2)
    assert tmesh.default_mesh_shape(7, 2) == (7, 1)
    jm, tm = meshes((4, 2), ("dp", "tp"))
    assert tm.shape == dict(jm.shape) == {"dp": 4, "tp": 2}
    assert tm.axis_devices("tp", dp=3) == [torch.device("cpu")] * 2
    assert tmesh.make_mesh(devices=CPU8).shape == {"data": 8}
    with pytest.raises(ValueError, match="needs 16 devices"):
        tmesh.make_mesh((4, 4), ("a", "b"), devices=CPU8)
    with pytest.raises(ValueError, match="needs 16 devices"):
        jmesh.make_mesh((4, 4), ("a", "b"))


def test_make_mesh_without_devices_takes_cuda_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.make_mesh(devices=["cuda"] * 2)


def _jax_collective(fn, x, n):
    m = jmesh.make_mesh((n,), ("a",))
    return np.asarray(shard_map(fn, mesh=m, in_specs=JP("a"), out_specs=JP("a"),
                                check_rep=False)(jnp.asarray(x)))


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_jax_lax(rng, n):
    x = rng.standard_normal((n * 4, 8, 8)).astype(np.float32)
    xs = list(torch.chunk(torch.from_numpy(x), n))
    # all_gather: each shard holds the stack of all
    got = tmesh.all_gather(xs)
    want = _jax_collective(lambda v: jax.lax.all_gather(v, "a")[None], x, n)
    for j in range(n):
        np.testing.assert_array_equal(got[j].numpy(), want[j])
    # psum
    got = tmesh.psum(xs)
    want = _jax_collective(lambda v: jax.lax.psum(v, "a"), x, n)
    np.testing.assert_allclose(torch.cat(got).numpy(), want, rtol=0, atol=1e-6)
    # ppermute around a ring, and a partial permutation (zeros where nothing arrives)
    for perm in ([(d, (d + 1) % n) for d in range(n)], [(0, n - 1)]):
        got = tmesh.ppermute(xs, perm)
        want = _jax_collective(lambda v: jax.lax.ppermute(v, "a", perm), x, n)
        np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    # all_to_all, both directions of the MoE's use
    for split, concat in ((0, 1), (1, 0)):
        got = tmesh.all_to_all(xs, split, concat)
        want = _jax_collective(
            lambda v: jax.lax.all_to_all(v, "a", split_axis=split, concat_axis=concat,
                                         tiled=True), x, n)
        np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    m = tmesh.make_mesh((n,), ("a",), devices=CPU8)
    assert tmesh.axis_index(m, "a", {"a": n - 1}) == n - 1


def test_split_rows_is_views_on_one_device():
    x = torch.arange(32.0).reshape(8, 4)
    parts = tmesh.split_rows(x, CPU8[:4])
    assert all(p.data_ptr() == x[2 * i].data_ptr() for i, p in enumerate(parts))
    with pytest.raises(ValueError, match="does not split"):
        tmesh.split_rows(x, CPU8[:3])


# -- sharded_topk and friends ----------------------------------------------


def _case(rng, n_rows, B, D=64, dead=0.02):
    x = _unit(rng.standard_normal((n_rows, D)))
    q = _unit(rng.standard_normal((B, D)))
    bias = np.zeros(n_rows, np.float32)
    bias[rng.choice(n_rows, int(n_rows * dead), replace=False)] = NEG_INF
    return q, x, bias


@pytest.mark.parametrize("B,k", [(3, 1), (3, 10), (40, 10), (40, 300)])
def test_sharded_topk_matches_jax(rng, B, k):
    jm, tm = meshes((8,), ("data",))
    q, x, bias = _case(rng, 8 * 128, B)
    js, ji = jss.sharded_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(bias), k, jm,
                              tile_n=64)
    ts, ti = tss.sharded_topk(*(torch.from_numpy(a) for a in (q, x, bias)), k, tm, tile_n=64)
    assert_topk_equiv(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji), q, x, bias, tol=TOL)


def test_sharded_topk_2d_and_hier_match_jax(rng):
    q, x, bias = _case(rng, 8 * 128, 16)
    args_t = [torch.from_numpy(a) for a in (q, x, bias)]
    args_j = [jnp.asarray(a) for a in (q, x, bias)]
    jm, tm = meshes((2, 4), ("q", "data"))
    js, ji = jss.sharded_topk_2d(*args_j, 7, jm, tile_n=128)
    ts, ti = tss.sharded_topk_2d(*args_t, 7, tm, tile_n=128)
    assert_topk_equiv(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji), q, x, bias, tol=TOL)
    jm, tm = meshes((2, 4), ("dcn", "ici"))
    js, ji = jss.sharded_topk_hier(*args_j, 7, jm, tile_n=128)
    ts, ti = tss.sharded_topk_hier(*args_t, 7, tm, tile_n=128)
    assert_topk_equiv(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji), q, x, bias, tol=TOL)
    # the two layouts give the 1-D merge's result
    fs, fi = tss.sharded_topk(*args_t, 7, tmesh.make_mesh((8,), ("data",), devices=CPU8),
                              tile_n=128)
    np.testing.assert_array_equal(fi.numpy(), ti.numpy())


def test_tie_across_shards_goes_to_the_lower_shard(rng):
    """Rows r and r + rows/shard identical: both packages keep shard 0's
    copy first, whatever the ids' order within a shard."""
    jm, tm = meshes((8,), ("data",))
    n_shard = 64
    x = _unit(rng.standard_normal((8 * n_shard, 32)))
    for s in (3, 5, 6):
        x[s * n_shard + 7] = x[2 * n_shard + 40]   # the same row in four shards
    bias = np.zeros(8 * n_shard, np.float32)
    q = x[[2 * n_shard + 40]].copy()
    js, ji = jss.sharded_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(bias), 4, jm,
                              tile_n=64)
    ts, ti = tss.sharded_topk(*(torch.from_numpy(a) for a in (q, x, bias)), 4, tm, tile_n=64)
    want = [2 * n_shard + 40, 3 * n_shard + 7, 5 * n_shard + 7, 6 * n_shard + 7]
    assert np.asarray(ji)[0].tolist() == want
    assert ti[0].tolist() == want
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("B", [3, 40])
def test_sharded_topk_int8_matches_jax(rng, B):
    from codegraph_tpu.ops.quantize import quantize_rows as jq
    from codegraph_tpu_torch.ops.quantize import quantize_rows as tq

    jm, tm = meshes((8,), ("data",))
    q, x, bias = _case(rng, 8 * 128, B)
    jqv, jqs = jq(jnp.asarray(q))
    jxv, jxs = jq(jnp.asarray(x))
    js, ji = jss.sharded_topk_int8(jqv, jqs, jxv, jxs, jnp.asarray(bias), 20, jm, tile_n=64)
    tqv, tqs = tq(torch.from_numpy(q))
    txv, txs = tq(torch.from_numpy(x))
    np.testing.assert_array_equal(txv.numpy(), np.asarray(jxv))
    ts, ti = tss.sharded_topk_int8(tqv, tqs, txv, txs, torch.from_numpy(bias), 20, tm, tile_n=64)
    true = ((np.asarray(jqv, np.float64) @ np.asarray(jxv, np.float64).T).astype(np.float32)
            * np.asarray(jqs)[:, None] * np.asarray(jxs)[None, :] + bias[None, :])
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))  # int8 scores: bit for bit
    assert_topk_equiv(ts.numpy(), ti.numpy(), np.asarray(js), np.asarray(ji), q, x, bias,
                      tol=0.0, true=true)


# -- the index classes -----------------------------------------------------


def _flat_pair(dtype, D=64, tile_n=64):
    jm, tm = meshes((8,), ("data",))
    return (jss.ShardedFlatIndex(D, jm, dtype=dtype, tile_n=tile_n),
            tss.ShardedFlatIndex(D, tm, dtype=dtype, tile_n=tile_n))


def _assert_index_same(j, t, q, k, extra_bias=None):
    js, ji = j.search(q, k, extra_bias=extra_bias)
    ts, ti = t.search(q, k, extra_bias=extra_bias)
    assert ts.shape == js.shape == (q.shape[0], k)
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    x = torch.cat(t.x_shards).float().numpy()
    bias = torch.cat(t.bias_shards).numpy().copy()
    if extra_bias is not None:
        bias[: len(extra_bias)] += extra_bias
    assert_topk_equiv(ts, ti, js, np.asarray(ji), _unit(q), x, bias, tol=TOL)
    np.testing.assert_array_equal(ti < 0, ji < 0)
    assert (ts[ti < 0] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [4, 40])  # K1 per shard, K2 per shard
def test_sharded_flat_index_build_add_delete_match_jax(rng, dtype, B):
    j, t = _flat_pair(dtype)
    a = rng.standard_normal((300, 64)).astype(np.float32)
    np.testing.assert_array_equal(t.build(a), j.build(a))
    assert t.capacity == j.capacity == 512
    q = rng.standard_normal((B, 64)).astype(np.float32)
    _assert_index_same(j, t, q, 10)
    # an add across a capacity growth (512 -> 1024), then deletes
    b = rng.standard_normal((400, 64)).astype(np.float32)
    np.testing.assert_array_equal(t.add(b), j.add(b))
    assert t.capacity == j.capacity == 1024 and t.n_rows == j.n_rows == 700
    dead = rng.choice(700, 70, replace=False)
    j.delete(dead)
    t.delete(dead)
    assert len(t) == len(j) == 630
    _assert_index_same(j, t, q, 10)
    # stored rows: the same normalised rows (bf16: up to one step)
    x = torch.cat(t.x_shards).float().numpy()
    jx = np.asarray(j._x, np.float32)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-7 if dtype == "float32" else 4e-3)
    _assert_index_same(j, t, b[:B] + 0.01, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_flat_index_extra_bias_matches_jax(rng, dtype):
    j, t = _flat_pair(dtype)
    a = rng.standard_normal((600, 64)).astype(np.float32)
    j.build(a)
    t.build(a)
    eb = np.where(rng.random(450) < 0.3, 0.0, NEG_INF).astype(np.float32)
    q = rng.standard_normal((5, 64)).astype(np.float32)
    _assert_index_same(j, t, q, 15, extra_bias=eb)


def test_bf16_index_scores_f32_queries_like_jax(rng):
    """The JAX sharded scan takes f32 queries over bf16 rows; so does the
    port's (unlike FlatIndex, which rounds a bf16 index's queries)."""
    j, t = _flat_pair("bfloat16")
    a = rng.standard_normal((500, 64)).astype(np.float32)
    j.build(a)
    t.build(a)
    q = rng.standard_normal((4, 64)).astype(np.float32)
    js, _ = j.search(q, 5)
    ts, ti = t.search(q, 5)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    rows = torch.cat(t.x_shards).float().numpy()
    f32_q = np.einsum("bd,bkd->bk", _unit(q).astype(np.float64), rows[ti].astype(np.float64))
    np.testing.assert_allclose(ts, f32_q, rtol=0, atol=1e-6)
    bf16_q = torch.from_numpy(_unit(q)).bfloat16().float().numpy().astype(np.float64)
    assert np.abs(np.einsum("bd,bkd->bk", bf16_q, rows[ti]) - ts).max() > 1e-5


def test_k_above_capacity_pads_like_jax(rng):
    j, t = _flat_pair("float32", tile_n=8)
    a = rng.standard_normal((20, 64)).astype(np.float32)
    j.build(a)
    t.build(a)
    assert t.capacity == j.capacity == 64
    q = rng.standard_normal((3, 64)).astype(np.float32)
    js, ji = j.search(q, 12)
    ts, ti = t.search(q, 12)
    assert (ti[:, 8:] == -1).all() and (ts[:, 8:] == np.float32(NEG_INF)).all()
    _assert_index_same(j, t, q, 12)
    # an empty index
    e_j, e_t = _flat_pair("float32")
    np.testing.assert_array_equal(e_t.search(q, 4)[1], e_j.search(q, 4)[1])


def test_sharded_index_takes_tensors_and_rejects_other_dims(rng):
    _, t = _flat_pair("float32")
    t.build(torch.from_numpy(rng.standard_normal((100, 64)).astype(np.float32)))
    from codegraph_tpu_torch.core.errors import DimensionMismatch

    with pytest.raises(DimensionMismatch):
        t.add(np.zeros((2, 63), np.float32))
    with pytest.raises(DimensionMismatch):
        t.search(np.zeros((2, 63), np.float32), 3)


@pytest.mark.parametrize("B", [4, 40])  # K5 per shard, K6 per shard
def test_sharded_int8_index_matches_jax(rng, B):
    jm, tm = meshes((8,), ("data",))
    j = jss.ShardedInt8Index(64, jm, tile_n=64, rescore_k=50)
    t = tss.ShardedInt8Index(64, tm, tile_n=64, rescore_k=50)
    x = rng.standard_normal((900, 64)).astype(np.float32)
    j.build(x)
    t.build(x)
    assert t.capacity == j.capacity == 1024
    np.testing.assert_allclose(t._host_f32, j._host_f32, rtol=0, atol=1e-7)
    q = rng.standard_normal((B, 64)).astype(np.float32)
    for k in (10, 60):
        js, ji = j.search(q, k)
        ts, ti = t.search(q, k)
        true = _unit(q).astype(np.float64) @ t._host_f32.T.astype(np.float64)
        assert_topk_equiv(ts, ti, js, ji, None, None, None, tol=TOL, true=true)
    j.delete(np.arange(0, 450))
    t.delete(np.arange(0, 450))
    js, ji = j.search(x[450:453], 5)
    ts, ti = t.search(x[450:453], 5)
    np.testing.assert_array_equal(ti, ji)
    assert (ti[:, 0] == np.arange(450, 453)).all() and (ti[ti >= 0] >= 450).all()


def test_hybrid_search_over_sharded_index_matches_jax():
    """The hybrid pipeline over a ShardedFlatIndex, in both packages, on the
    same nodes: the same hits, scores within 1e-5."""
    from codegraph_tpu.core import types as jtypes
    from codegraph_tpu.graph.store import GraphStore as JStore
    from codegraph_tpu.models.providers import HashProvider as JHash
    from codegraph_tpu.search.bm25 import BM25Index as JBM25
    from codegraph_tpu.search.hybrid import HybridSearch as JHybrid
    from codegraph_tpu_torch.core import types as ttypes
    from codegraph_tpu_torch.graph.store import GraphStore as TStore
    from codegraph_tpu_torch.models.providers import HashProvider as THash
    from codegraph_tpu_torch.search.bm25 import BM25Index as TBM25
    from codegraph_tpu_torch.search.hybrid import HybridSearch as THybrid

    texts = {f"handler_{i}": f"def handler_{i}(req): processes request type {i} via queue {i % 5}"
             for i in range(40)}

    def build(types, Store, Hash, BM25, Hybrid, Index, mesh):
        store = Store()
        provider = Hash(64)
        nodes = [types.CodeNode.make("p", n, types.NodeType.FUNCTION, types.Language.PYTHON,
                                     types.Location(f"{n}.py", 1, 3), content=txt)
                 for n, txt in texts.items()]
        store.upsert_nodes(nodes)
        chunks = [types.CodeChunk.make(n.id, texts[n.name], 0, 1) for n in nodes]
        rows = store.upsert_chunks(chunks)
        index = Index(64, mesh, tile_n=64)
        np.testing.assert_array_equal(index.build(provider.embed_texts([c.text for c in chunks])),
                                      rows)
        bm25 = BM25()
        for n in nodes:
            bm25.add(n.row, f"{n.name} {n.content}")
        return Hybrid(store, index, provider, bm25)

    jm, tm = meshes((8,), ("data",))
    jh = build(jtypes, JStore, JHash, JBM25, JHybrid, jss.ShardedFlatIndex, jm)
    th = build(ttypes, TStore, THash, TBM25, THybrid, tss.ShardedFlatIndex, tm)
    assert th._index_filter_ok and jh._index_filter_ok
    for query in ("processes request type 7", "queue 3 handler", "type 12"):
        jr = jh.search_text(query, limit=5)
        tr = th.search_text(query, limit=5)
        assert [r.name for r in tr] == [r.name for r in jr]
        np.testing.assert_allclose([r.score for r in tr], [r.score for r in jr], atol=1e-5)

"""The port's ring attention and GPipe encoder (`codegraph_tpu_torch/parallel/
ring_attention.py`, `pipeline.py`) held to the JAX package's on the CPU,
and to the port's dense `encode`.

One numpy-seeded f32 parameter set goes into both packages (the JAX side
on conftest's 8 CPU devices, the port's on `[cpu] * n`). Tolerances:
outputs within 2e-5 (the JAX tests' own bound for the streaming softmax;
1e-5 for the pipeline, which changes no sum), gradients within 1e-4
relative L2 per parameter.
"""

import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from codegraph_tpu.models import encoder as jenc
from codegraph_tpu.parallel import mesh as jmesh
from codegraph_tpu.parallel import pipeline as jpipe
from codegraph_tpu_torch.models import encoder as tenc
from codegraph_tpu_torch.parallel import mesh as tmesh
from codegraph_tpu_torch.parallel import pipeline as tpipe

from tests.test_torch_encoder import numpy_params

# the packages export the function `ring_attention` under the module's name
jring = importlib.import_module("codegraph_tpu.parallel.ring_attention")
tring = importlib.import_module("codegraph_tpu_torch.parallel.ring_attention")

with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    from jax.experimental.shard_map import shard_map

RING_TOL = 2e-5
PP_TOL = 1e-5
GRAD_REL = 1e-4
CPU8 = [torch.device("cpu")] * 8


def cfgs(**kw):
    base = dict(vocab_size=64, hidden=64, n_layers=2, n_heads=4, max_len=32)
    base.update(kw)
    return (jenc.EncoderConfig(**base, dtype=jnp.float32),
            tenc.EncoderConfig(**base, dtype=torch.float32))


def batch(seed, B, L):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 64, (B, L)).astype(np.int32)
    mask = np.zeros((B, L), bool)
    for i in range(B):
        mask[i, : max(L - 3 * i, 4)] = True   # ragged padding
    ids[~mask] = 0
    return ids, mask


def both_params(jcfg, seed=0):
    tree = numpy_params(jcfg, seed=seed)
    return jax.tree.map(jnp.asarray, tree), tenc.encoder_params_from_jax(tree)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def grads_torch(fn, params):
    live = {n: v.clone().requires_grad_(True) for n, v in params.items()}
    torch.sum(fn(live)).backward()
    return {n: v.grad.numpy() for n, v in live.items()}


def assert_grads(tg, jg_tree, exact=()):
    want = tenc.encoder_params_from_jax(jax.tree.map(np.asarray, jg_tree))
    for n, g in tg.items():
        assert np.isfinite(g).all(), n
        assert rel(g, want[n].numpy()) <= GRAD_REL, n


# -- ring attention ---------------------------------------------------------


def test_ring_attention_matches_jax(rng):
    n, B, Ll, nh, hd = 4, 2, 8, 4, 16
    q, k, v = (rng.standard_normal((B, n * Ll, nh, hd)).astype(np.float32) for _ in range(3))
    mask = rng.random((B, n * Ll)) < 0.7
    mask[:, 0] = True
    jm = jmesh.make_mesh((n,), ("sp",))
    spec = JP(None, "sp")
    want = np.asarray(shard_map(
        lambda a, b, c, m: jring.ring_attention(a, b, c, m, "sp", n), mesh=jm,
        in_specs=(spec, spec, spec, spec), out_specs=spec, check_rep=False)(
        *(jnp.asarray(t) for t in (q, k, v, mask))))
    split = lambda t: list(torch.chunk(torch.from_numpy(t), n, dim=1))  # noqa: E731
    got = torch.cat(tring.ring_attention(split(q), split(k), split(v), split(mask)), dim=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=RING_TOL)
    # and the dense softmax it streams
    logits = np.einsum("bqnd,bknd->bnqk", q, k) / np.sqrt(hd) + np.where(
        mask[:, None, None, :], 0.0, -1e30)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    dense = np.einsum("bnqk,bknd->bqnd", p / p.sum(-1, keepdims=True), v)
    np.testing.assert_allclose(got.numpy(), dense, rtol=0, atol=RING_TOL)


@pytest.mark.parametrize("shape,axes,dp", [((4,), ("sp",), None), ((2, 4), ("dp", "sp"), "dp")])
def test_sp_ring_encode_matches_jax_and_dense(shape, axes, dp):
    jcfg, tcfg = cfgs()
    jp, tp = both_params(jcfg)
    ids, mask = batch(0, 4, 32)
    jm = jmesh.make_mesh(shape, axes)
    tm = tmesh.make_mesh(shape, axes, devices=CPU8)
    want = np.asarray(jax.jit(lambda p: jring.sp_ring_encode(
        p, jnp.asarray(ids), jnp.asarray(mask), jcfg, jm, sp_axis="sp", dp_axis=dp))(jp))
    ti, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    got = tring.sp_ring_encode(tp, ti, tmask, tcfg, tm, sp_axis="sp", dp_axis=dp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RING_TOL)
    dense = tenc.encode(tp, ti, tmask, tcfg).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=RING_TOL)


def test_sp_ring_gradients_match_jax():
    jcfg, tcfg = cfgs()
    jp, tp = both_params(jcfg, seed=2)
    ids, mask = batch(2, 2, 32)
    jm = jmesh.make_mesh((4,), ("sp",))
    tm = tmesh.make_mesh((4,), ("sp",), devices=CPU8)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jring.sp_ring_encode(
        p, jnp.asarray(ids), jnp.asarray(mask), jcfg, jm, sp_axis="sp"))))(jp)
    ti, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    tg = grads_torch(lambda p: tring.sp_ring_encode(p, ti, tmask, tcfg, tm, sp_axis="sp"), tp)
    assert_grads(tg, jg)
    dense = grads_torch(lambda p: tenc.encode(p, ti, tmask, tcfg), tp)
    for n in tg:
        assert rel(tg[n], dense[n]) <= GRAD_REL, n


def test_sp_ring_refuses_what_jax_refuses():
    _, tcfg = cfgs(n_experts=2)
    tm = tmesh.make_mesh((2,), ("sp",), devices=CPU8)
    p = tenc.init_encoder_params(tcfg, torch.Generator().manual_seed(0))
    ids = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="MoE"):
        tring.sp_ring_encode(p, ids, ids > -1, tcfg, tm)
    _, tcfg = cfgs(pooling="cls")
    p = tenc.init_encoder_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="mean only"):
        tring.sp_ring_encode(p, ids, ids > -1, tcfg, tm)
    _, tcfg = cfgs()
    p = tenc.init_encoder_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="divide by sp"):
        tring.sp_ring_encode(p, torch.zeros((1, 7), dtype=torch.int32),
                             torch.ones((1, 7), dtype=torch.bool), tcfg, tm)


# -- GPipe, and GPipe x tp --------------------------------------------------


@pytest.mark.parametrize("n_layers,shape,axes,tp_axis,n_micro", [
    (4, (4,), ("pp",), None, 4),
    (4, (2,), ("pp",), None, 2),
    (6, (3,), ("pp",), None, 4),
    (2, (2, 4), ("pp", "tp"), "tp", 4),
    (4, (2, 2), ("pp", "tp"), "tp", 2),
])
def test_pp_encode_matches_jax_and_dense(n_layers, shape, axes, tp_axis, n_micro):
    jcfg, tcfg = cfgs(n_layers=n_layers)
    jp, tp = both_params(jcfg, seed=n_layers)
    ids, mask = batch(3, 8, 24)
    jm = jmesh.make_mesh(shape, axes)
    tm = tmesh.make_mesh(shape, axes, devices=CPU8)
    want = np.asarray(jax.jit(lambda p: jpipe.pp_encode(
        p, jnp.asarray(ids), jnp.asarray(mask), jcfg, jm, n_micro=n_micro, tp_axis=tp_axis))(jp))
    ti, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    got = tpipe.pp_encode(tp, ti, tmask, tcfg, tm, n_micro=n_micro, tp_axis=tp_axis).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=PP_TOL)
    dense = tenc.encode(tp, ti, tmask, tcfg).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=PP_TOL)


@pytest.mark.parametrize("shape,axes,tp_axis", [((2,), ("pp",), None),
                                               ((2, 2), ("pp", "tp"), "tp")])
def test_pp_encode_gradients_match_jax(shape, axes, tp_axis):
    jcfg, tcfg = cfgs(n_layers=2)
    jp, tp = both_params(jcfg, seed=7)
    ids, mask = batch(4, 4, 16)
    jm = jmesh.make_mesh(shape, axes)
    tm = tmesh.make_mesh(shape, axes, devices=CPU8)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jpipe.pp_encode(
        p, jnp.asarray(ids), jnp.asarray(mask), jcfg, jm, n_micro=2, tp_axis=tp_axis))))(jp)
    ti, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    tg = grads_torch(lambda p: tpipe.pp_encode(p, ti, tmask, tcfg, tm, n_micro=2,
                                               tp_axis=tp_axis), tp)
    assert_grads(tg, jg)
    per_layer = np.abs(tg["layers.wqkv"]).sum(axis=(1, 2))
    assert (per_layer > 0).all()   # every stage received gradient


@pytest.mark.parametrize("kw", [
    dict(norm_style="post", attn_bias=True, act="gelu_exact", pooling="cls"),
    dict(n_experts=4, moe_top_k=2, moe_capacity=1.0, pooling="max"),
    dict(n_experts=4),
], ids=["post-ln-biases-cls", "routed-moe-max", "dense-moe"])
@pytest.mark.parametrize("shape,axes,tp_axis", [((2,), ("pp",), None),
                                               ((2, 2), ("pp", "tp"), "tp")])
def test_pp_encode_follows_cfg_as_encode_does(kw, shape, axes, tp_axis):
    """Where the JAX stage hard-codes a pre-LN dense layer without biases and
    a masked mean, the port's stage runs the encoder's own layer and
    pooling: pp_encode equals the dense `encode` on every cfg."""
    _, tcfg = cfgs(**kw)
    p = tenc.init_encoder_params(tcfg, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(5)
    for n, v in p.items():   # the init's zero biases would hide a dropped bias
        if n.split(".")[-1].startswith("b_") or n.endswith("_bias"):
            p[n] = v + torch.from_numpy(0.1 * rng.standard_normal(v.shape).astype(np.float32))
    ids, mask = batch(6, 8, 24)
    ti, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    tm = tmesh.make_mesh(shape, axes, devices=CPU8)
    got = tpipe.pp_encode(p, ti, tmask, tcfg, tm, n_micro=2, tp_axis=tp_axis).numpy()
    np.testing.assert_allclose(got, tenc.encode(p, ti, tmask, tcfg).numpy(), rtol=0,
                               atol=PP_TOL)


def test_pipeline_param_shardings_match_jax():
    for kw in ({}, {"n_experts": 4}, {"attn_bias": True}):
        jcfg, tcfg = cfgs(**kw)
        want = jpipe.pipeline_param_shardings(jcfg)
        got = tpipe.pipeline_param_shardings(tcfg)
        flat = {k: tuple(v) for k, v in want.items() if k != "layers"}
        flat.update({tenc.LAYER_PREFIX + k: tuple(v) for k, v in want["layers"].items()})
        assert got == flat
        jspec = jenc.encoder_param_shardings(jcfg)
        tspec = tenc.encoder_param_shardings(tcfg)
        flat = {k: tuple(v) for k, v in jspec.items() if k != "layers"}
        flat.update({tenc.LAYER_PREFIX + k: tuple(v) for k, v in jspec["layers"].items()})
        assert tspec == flat
        assert set(tspec) == set(tenc.init_encoder_params(tcfg, torch.Generator()))


def test_pp_encode_raises_where_jax_asserts():
    _, tcfg = cfgs(n_layers=3)
    p = tenc.init_encoder_params(tcfg, torch.Generator().manual_seed(0))
    ids = torch.zeros((4, 8), dtype=torch.int32)
    mask = torch.ones((4, 8), dtype=torch.bool)
    tm = tmesh.make_mesh((2,), ("pp",), devices=CPU8)
    with pytest.raises(ValueError, match="n_layers=3"):
        tpipe.pp_encode(p, ids, mask, tcfg, tm, n_micro=2)
    _, tcfg = cfgs(n_layers=2)
    p = tenc.init_encoder_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="n_micro=3"):
        tpipe.pp_encode(p, ids, mask, tcfg, tm, n_micro=3)
    tm = tmesh.make_mesh((1, 8), ("pp", "tp"), devices=CPU8)
    with pytest.raises(ValueError, match="tp=8"):
        tpipe.pp_encode(p, ids, mask, tcfg, tm, n_micro=2, tp_axis="tp")

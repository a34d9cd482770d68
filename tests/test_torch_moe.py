"""The port's routed mixture of experts (`codegraph_tpu_torch/parallel/moe.py`
and the encoder's `_moe_mlp_routed`) held to the JAX package's on the CPU.

Parameters and tokens come from numpy seeds and go into both packages.
Tolerances: 1e-5 absolute for f32 outputs (products summed in another
order; outputs are O(1)), 1e-4 relative L2 for gradients. The expert choice
is `lax.top_k` (a tie to the lower expert) and the slots are the
token-major arrival order, so the same tokens drop at a tight capacity:
the slot and keep arrays are compared exactly. The ep=4 all-to-all runs on
a mesh of `[cpu] * 4` (JAX: 4 of conftest's 8 CPU devices).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.models import encoder as jenc
from codegraph_tpu.parallel import mesh as jmesh
from codegraph_tpu.parallel import moe as jmoe
from codegraph_tpu_torch.models import encoder as tenc
from codegraph_tpu_torch.parallel import mesh as tmesh
from codegraph_tpu_torch.parallel import moe as tmoe

from tests.test_torch_encoder import numpy_params

ATOL = 1e-5
GRAD_REL = 1e-4
H, F, E, T = 32, 64, 8, 64
CPU8 = [torch.device("cpu")] * 8


def np_moe(seed=0, h=H, f=F, e=E):
    r = np.random.default_rng(seed)
    return {
        "gate": (r.standard_normal((h, e)) / np.sqrt(h)).astype(np.float32),
        "w_up_e": (r.standard_normal((e, h, f)) / np.sqrt(h)).astype(np.float32),
        "b_up_e": (0.1 * r.standard_normal((e, f))).astype(np.float32),
        "w_down_e": (r.standard_normal((e, f, h)) / np.sqrt(f)).astype(np.float32),
        "b_down_e": (0.1 * r.standard_normal((e, h))).astype(np.float32),
    }


@pytest.fixture
def setup(rng):
    p = np_moe()
    x = rng.standard_normal((T, H)).astype(np.float32)
    return x, p, {k: jnp.asarray(v) for k, v in p.items()}, tmoe.moe_params_from_jax(p)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_dense_oracle_matches_jax(setup, k):
    x, _, jp, tp = setup
    want = np.asarray(jmoe.topk_moe_dense(jnp.asarray(x), jp, k=k))
    got = tmoe.topk_moe_dense(torch.from_numpy(x), tp, k=k).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("capacity", [8.0, 2.0, 0.5, 0.25])
def test_dispatch_matches_jax_and_drops_the_same_tokens(setup, capacity):
    x, _, jp, tp = setup
    want = np.asarray(jmoe.topk_moe_dispatch(jnp.asarray(x), jp, k=2, capacity_factor=capacity))
    got = tmoe.topk_moe_dispatch(torch.from_numpy(x), tp, k=2, capacity_factor=capacity).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the slots and the drops themselves
    scores = x @ np_moe()["gate"]
    _, top_e = jax.lax.top_k(jnp.asarray(scores), 2)
    C = tmoe.capacity(capacity, T, 2, E)
    jpos, jkeep = jmoe._dispatch_indices(top_e, 2, E, C)
    tpos, tkeep = tmoe._dispatch_indices(torch.from_numpy(np.array(top_e)).long(), 2, E, C)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    if capacity >= 8.0:
        assert tkeep.all()
        dense = tmoe.topk_moe_dense(torch.from_numpy(x), tp, k=2).numpy()
        np.testing.assert_allclose(got, dense, rtol=0, atol=ATOL)
    elif capacity <= 0.5:
        assert not tkeep.all()


def test_expert_ties_go_to_the_lower_expert():
    scores = torch.tensor([[0.5, 2.0, 2.0, 1.0, 2.0]])
    s, e = tmoe.topk_experts(scores, 3)
    js, je = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)
    assert e.tolist() == np.asarray(je).tolist() == [[1, 2, 4]]


@pytest.mark.parametrize("ep,k,capacity", [(4, 2, 8.0), (8, 2, 8.0), (4, 1, 8.0), (4, 2, 1.0)])
def test_sharded_all_to_all_matches_jax_and_dense(setup, ep, k, capacity):
    x, _, jp, tp = setup
    jm = jmesh.make_mesh((ep,), ("ep",))
    tm = tmesh.make_mesh((ep,), ("ep",), devices=CPU8)
    want = np.asarray(jmoe.make_sharded_topk_moe(jm, "ep", k=k, capacity_factor=capacity)(
        jnp.asarray(x), jp))
    got = tmoe.make_sharded_topk_moe(tm, "ep", k=k, capacity_factor=capacity)(
        torch.from_numpy(x), tp).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if capacity >= 8.0:
        dense = tmoe.topk_moe_dense(torch.from_numpy(x), tp, k=k).numpy()
        np.testing.assert_allclose(got, dense, rtol=0, atol=ATOL)


def test_sharded_moe_gradients_match_jax(setup):
    x, _, jp, tp = setup
    jm = jmesh.make_mesh((4,), ("ep",))
    tm = tmesh.make_mesh((4,), ("ep",), devices=CPU8)
    jfwd = jmoe.make_sharded_topk_moe(jm, "ep", k=2, capacity_factor=4.0)
    jg = jax.grad(lambda p: jnp.sum(jnp.square(jfwd(jnp.asarray(x), p))))(jp)
    live = {n: v.clone().requires_grad_(True) for n, v in tp.items()}
    tfwd = tmoe.make_sharded_topk_moe(tm, "ep", k=2, capacity_factor=4.0)
    torch.sum(torch.square(tfwd(torch.from_numpy(x), live))).backward()
    for n in live:
        g = live[n].grad.numpy()
        assert np.isfinite(g).all()
        assert rel(g, jg[n]) <= GRAD_REL, n
    for n in ("gate", "w_up_e", "w_down_e"):
        assert np.abs(live[n].grad.numpy()).max() > 0, n


def test_init_moe_params_shapes_and_scales():
    p = tmoe.init_moe_params(torch.Generator().manual_seed(0), 128, 512, 4)
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), 128, 512, 4)
    for n in jp:
        assert tuple(p[n].shape) == jp[n].shape and p[n].dtype == torch.float32
        assert abs(float(p[n].std()) - float(jnp.std(jp[n]))) <= 0.1 * float(jnp.std(jp[n])) + 1e-9


# -- the encoder's routed path ---------------------------------------------


@pytest.mark.parametrize("capacity", [float(E), 2.0, 0.25])
def test_encoder_routed_block_matches_jax(rng, capacity):
    p = np_moe(1)
    x = rng.standard_normal((3, 16, H)).astype(np.float32)
    args = [p[n] for n in ("gate", "w_up_e", "b_up_e", "w_down_e", "b_down_e")]
    want = np.asarray(jenc._moe_mlp_routed(jnp.asarray(x), *(jnp.asarray(a) for a in args),
                                           top_k=2, capacity_factor=capacity))
    got = tenc._moe_mlp_routed(torch.from_numpy(x), *(torch.from_numpy(a) for a in args),
                               top_k=2, capacity_factor=capacity).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if capacity == 0.25:
        # tokens that lost both experts to capacity output exactly zero, in both
        zero = np.linalg.norm(got.reshape(-1, H), axis=1) == 0
        assert zero.any()
        np.testing.assert_array_equal(zero, np.linalg.norm(want.reshape(-1, H), axis=1) == 0)
    if capacity == float(E):   # nothing drops: the dense oracle per batch row
        tp = tmoe.moe_params_from_jax(p)
        for b in range(3):
            np.testing.assert_allclose(
                got[b], tmoe.topk_moe_dense(torch.from_numpy(x[b]), tp, k=2).numpy(),
                rtol=0, atol=ATOL)


ROUTED = dict(vocab_size=64, hidden=32, n_layers=2, n_heads=4, max_len=32, n_experts=8,
              moe_top_k=2)


def _routed_cfgs(capacity):
    j = jenc.EncoderConfig(**ROUTED, moe_capacity=capacity, dtype=jnp.float32)
    t = tenc.EncoderConfig(**ROUTED, moe_capacity=capacity, dtype=torch.float32)
    return j, t


def _tokens(rng, B=4, L=16):
    ids = rng.integers(0, 64, (B, L)).astype(np.int32)
    mask = np.arange(L)[None] < rng.integers(3, L + 1, B)[:, None]
    return ids, mask


@pytest.mark.parametrize("capacity", [8.0, 1.0])
def test_encoder_routed_matches_jax_with_and_without_ep(rng, capacity):
    jcfg, tcfg = _routed_cfgs(capacity)
    assert dataclasses.asdict(tcfg).keys() == dataclasses.asdict(jcfg).keys()
    tree = numpy_params(jcfg, seed=3)
    ids, mask = _tokens(rng)
    want = np.asarray(jax.jit(lambda p: jenc.encode(p, jnp.asarray(ids), jnp.asarray(mask), jcfg))(
        jax.tree.map(jnp.asarray, tree)))
    tp = tenc.encoder_params_from_jax(tree)
    ti, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    got = tenc.encode(tp, ti, tmask, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # dp x ep (2, 4), as the JAX package's test shards it
    mesh = tmesh.make_mesh((2, 4), ("dp", "ep"), devices=CPU8)
    sharded = tenc.encode(tp, ti, tmask, tcfg, mesh=mesh, dp_axis="dp", ep_axis="ep").numpy()
    np.testing.assert_allclose(sharded, want, rtol=0, atol=ATOL)
    jmesh_ = jmesh.make_mesh((2, 4), ("dp", "ep"))
    with jmesh_:
        jsh = np.asarray(jax.jit(lambda p, i, m: jenc.encode(p, i, m, jcfg, mesh=jmesh_,
                                                            dp_axis="dp", ep_axis="ep"))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(sharded, jsh, rtol=0, atol=ATOL)


def test_encoder_routed_on_ep_tp_and_sp(rng):
    """Routed experts over (ep, tp) with the rows sequence-sharded: routing
    gathers each row over sp; the same result as without a mesh."""
    jcfg, tcfg = _routed_cfgs(2.0)
    tp = tenc.encoder_params_from_jax(numpy_params(jcfg, seed=4))
    ids, mask = _tokens(rng, B=2, L=16)
    ti, tmask = torch.from_numpy(ids), torch.from_numpy(mask)
    want = tenc.encode(tp, ti, tmask, tcfg).numpy()
    mesh = tmesh.make_mesh((2, 2, 2), ("sp", "ep", "tp"), devices=CPU8)
    got = tenc.encode(tp, ti, tmask, tcfg, mesh=mesh, sp_axis="sp", ep_axis="ep").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_encoder_routed_gradients_match_jax(rng):
    jcfg, tcfg = _routed_cfgs(4.0)
    jcfg = dataclasses.replace(jcfg, n_layers=1)
    tcfg = dataclasses.replace(tcfg, n_layers=1)
    tree = numpy_params(jcfg, seed=5)
    ids, mask = _tokens(rng, B=2, L=16)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jenc.encode(p, jnp.asarray(ids), jnp.asarray(mask),
                                                        jcfg))))(jax.tree.map(jnp.asarray, tree))
    live = {n: v.clone().requires_grad_(True) for n, v in tenc.encoder_params_from_jax(tree).items()}
    mesh = tmesh.make_mesh((2, 2), ("dp", "ep"), devices=CPU8)
    for kw in ({}, dict(mesh=mesh, dp_axis="dp", ep_axis="ep")):
        for v in live.values():
            v.grad = None
        torch.sum(tenc.encode(live, torch.from_numpy(ids), torch.from_numpy(mask), tcfg,
                              **kw)).backward()
        want = tenc.encoder_params_from_jax(jax.tree.map(np.asarray, jg))
        for n in live:
            assert rel(live[n].grad.numpy(), want[n].numpy()) <= GRAD_REL, (n, kw)
        for n in ("layers.gate", "layers.w_up_e", "layers.w_down_e"):
            assert np.abs(live[n].grad.numpy()).max() > 0, n

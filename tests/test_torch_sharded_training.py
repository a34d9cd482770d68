"""The port's sharded encode and training step (`models/encoder.py` `encode`
with a mesh, `parallel/sharded_encode.py`, `models/training.py`
`make_sharded_train_step`) held to the port's unsharded forward and to the
JAX package's sharded step on the CPU.

The port's mesh is `[cpu] * 8`, the JAX package's conftest's 8 CPU devices.
Tolerances: f32 embeddings within 1e-5 of the unsharded forward (the tp
parts and the gathered attention sum in another order), bf16 within 5e-3
(a part's f32 sum may round to the neighbouring bf16 value); a step's loss,
grad norm and parameters as tests/test_torch_training.py holds the
unsharded step (loss and grad norm within 1e-5 relative, all but 1 in
1,000 parameter entries within 1e-5, every entry within 2 lr a step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.models import encoder as jenc
from codegraph_tpu.models import training as jt
from codegraph_tpu.parallel import mesh as jmesh
from codegraph_tpu_torch.models import encoder as tenc
from codegraph_tpu_torch.models import training as tt
from codegraph_tpu_torch.parallel import mesh as tmesh

from tests.test_torch_encoder import numpy_params
from tests.test_torch_training import LR, assert_metrics, assert_params, pair_batch

F32_TOL = 1e-5
BF16_TOL = 5e-3
CPU8 = [torch.device("cpu")] * 8
SMALL = dict(vocab_size=512, hidden=64, n_layers=2, n_heads=4, max_len=16)


def tmesh_(shape, axes):
    return tmesh.make_mesh(shape, axes, devices=CPU8)


def inputs(seed=1, B=8, L=16, vocab=512):
    r = np.random.default_rng(seed)
    ids = r.integers(0, vocab, (B, L)).astype(np.int32)
    mask = np.arange(L)[None] < r.integers(1, L + 1, B)[:, None]
    mask[-1] = False  # a fully padded row
    return torch.from_numpy(ids), torch.from_numpy(mask)


VARIANTS = {
    "base": {},
    "bert": dict(norm_style="post", attn_bias=True, act="gelu_exact", pooling="cls"),
    "max": dict(pooling="max"),
    "moe_dense": dict(n_experts=4),
    "moe_routed": dict(n_experts=4, moe_top_k=2, moe_capacity=1.5),
}
MESHES = {
    "dp_sp_tp": ((2, 2, 2), ("dp", "sp", "tp"), dict(dp_axis="dp", sp_axis="sp")),
    "dp_tp": ((4, 2), ("dp", "tp"), dict(dp_axis="dp")),
    "sp": ((4,), ("sp",), dict(sp_axis="sp")),
    "dp_ep_tp": ((2, 2, 2), ("dp", "ep", "tp"), dict(dp_axis="dp", ep_axis="ep")),
}
CASES = [(v, m) for v in VARIANTS for m in MESHES
         if (m == "dp_ep_tp") == v.startswith("moe") or (v.startswith("moe") and m == "sp")]


@pytest.mark.parametrize("variant,mesh_name", CASES)
def test_encode_on_a_mesh_equals_encode_without(variant, mesh_name):
    cfg = tenc.EncoderConfig(**SMALL, **VARIANTS[variant], dtype=torch.float32)
    jcfg = jenc.EncoderConfig(**SMALL, **VARIANTS[variant], dtype=jnp.float32)
    params = tenc.encoder_params_from_jax(numpy_params(jcfg, seed=2))
    ids, mask = inputs()
    want = tenc.encode(params, ids, mask, cfg)
    shape, axes, kw = MESHES[mesh_name]
    got = tenc.encode(params, ids, mask, cfg, mesh=tmesh_(shape, axes), **kw)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=F32_TOL)


def test_bf16_encode_on_a_mesh():
    jcfg = jenc.EncoderConfig(**SMALL, dtype=jnp.bfloat16)
    cfg = tenc.EncoderConfig(**SMALL, dtype=torch.bfloat16)
    params = tenc.encoder_params_from_jax(numpy_params(jcfg, seed=3))
    ids, mask = inputs(seed=4)
    want = tenc.encode(params, ids, mask, cfg).numpy()
    shape, axes, kw = MESHES["dp_sp_tp"]
    got = tenc.encode(params, ids, mask, cfg, mesh=tmesh_(shape, axes), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)


def test_encode_on_a_mesh_matches_jax_sharded_encode():
    jcfg = jenc.EncoderConfig(**SMALL, dtype=jnp.float32)
    cfg = tenc.EncoderConfig(**SMALL, dtype=torch.float32)
    tree = numpy_params(jcfg, seed=5)
    ids, mask = inputs(seed=6)
    jm = jmesh.make_mesh((2, 2, 2), ("dp", "sp", "tp"))
    want = np.asarray(jax.jit(lambda p, i, m: jenc.encode(p, i, m, jcfg, mesh=jm, dp_axis="dp",
                                                          sp_axis="sp"))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(ids.numpy()), jnp.asarray(mask.numpy())))
    got = tenc.encode(tenc.encoder_params_from_jax(tree), ids, mask, cfg,
                      mesh=tmesh_((2, 2, 2), ("dp", "sp", "tp")), dp_axis="dp", sp_axis="sp")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


class _LoggingMesh(tmesh.Mesh):
    """A mesh that records the coordinates asked of it."""

    def __init__(self, mesh):
        super().__init__(mesh.devices, mesh.axis_names)
        self.asked = set()

    def device(self, **coords):
        self.asked.add(tuple(sorted(coords.items())))
        return super().device(**coords)


def test_every_device_of_the_mesh_takes_its_part():
    """dp x sp token shards and their tp parts run on the devices at their
    coordinates: all 8 of a (2, 2, 2) mesh are asked for."""
    cfg = tenc.EncoderConfig(**SMALL, dtype=torch.float32)
    params = tenc.init_encoder_params(cfg, torch.Generator().manual_seed(0))
    ids, mask = inputs()
    mesh = _LoggingMesh(tmesh_((2, 2, 2), ("dp", "sp", "tp")))
    tenc.encode(params, ids, mask, cfg, mesh=mesh, dp_axis="dp", sp_axis="sp")
    full = {c for c in mesh.asked if len(c) == 3}
    assert full == {(("dp", i), ("sp", j), ("tp", t)) for i in range(2) for j in range(2)
                    for t in range(2)}


def test_remat_on_a_mesh_gives_the_same_gradients():
    jcfg = jenc.EncoderConfig(**SMALL, dtype=jnp.float32)
    params = tenc.encoder_params_from_jax(numpy_params(jcfg, seed=9))
    ids, mask = inputs(seed=10)
    mesh = tmesh_((2, 2, 2), ("dp", "sp", "tp"))
    grads = []
    for remat in (False, True):
        cfg = tenc.EncoderConfig(**SMALL, remat=remat, dtype=torch.float32)
        live = {n: v.clone().requires_grad_(True) for n, v in params.items()}
        torch.sum(tenc.encode(live, ids, mask, cfg, mesh=mesh, dp_axis="dp", sp_axis="sp")
                  ).backward()
        grads.append({n: v.grad for n, v in live.items()})
    # the recomputed layers add the shards' gradient parts in another order
    for n in grads[0]:
        assert torch.allclose(grads[0][n], grads[1][n], rtol=1e-5, atol=1e-7), n


def test_unknown_axes_raise():
    cfg = tenc.EncoderConfig(**SMALL, dtype=torch.float32)
    params = tenc.init_encoder_params(cfg, torch.Generator().manual_seed(0))
    ids, mask = inputs()
    mesh = tmesh_((4, 2), ("dp", "tp"))
    with pytest.raises(ValueError, match="'sp'"):
        tenc.encode(params, ids, mask, cfg, mesh=mesh, sp_axis="sp")
    with pytest.raises(ValueError, match="'sp'"):
        tt.make_sharded_train_step(mesh, cfg, tt.TrainConfig(), sp_axis="sp")
    with pytest.raises(ValueError, match="first device"):
        tt.make_sharded_train_step(mesh, cfg, tt.TrainConfig(), device="cuda:0")
    with pytest.raises(ValueError, match="tp=8"):
        tenc.encode(params, ids, mask, cfg, mesh=tmesh_((8,), ("tp",)))


STEP_CASES = {
    "dp_sp_tp": ({}, (2, 2, 2), ("dp", "sp", "tp"), dict(sp_axis="sp")),
    "dp_ep_tp": (dict(n_experts=4, moe_top_k=2, moe_capacity=2.0), (2, 2, 2),
                 ("dp", "ep", "tp"), dict(ep_axis="ep")),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_sharded_train_step_matches_jax(case):
    extra, shape, axes, kw = STEP_CASES[case]
    jcfg = jenc.EncoderConfig(**SMALL, **extra, dtype=jnp.float32)
    tcfg = tenc.EncoderConfig(**SMALL, **extra, dtype=torch.float32)
    tc = jt.TrainConfig(learning_rate=LR)
    tree = numpy_params(jcfg, seed=8)
    jm = jmesh.make_mesh(shape, axes)
    jstep, _ = jt.make_sharded_train_step(jm, jcfg, tc, **kw)
    jopt = jt.make_optimizer(tc)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jax.jit(jopt.init)(jp)
    ttc = tt.TrainConfig(**dataclasses.asdict(tc))
    tstep, tinit = tt.make_sharded_train_step(tmesh_(shape, axes), tcfg, ttc, **kw)
    p0, s0 = tinit(torch.Generator().manual_seed(0))
    assert set(p0) == set(tenc.encoder_params_from_jax(tree)) and s0["count"] == 0
    tp = tenc.encoder_params_from_jax(tree)
    ts = tt.make_optimizer(ttc).init(tp)
    # the same step without a mesh, for the loss over the global batch
    plain = tt.make_sharded_train_step(None, tcfg, ttc, device="cpu")[0]
    pp, ps = tp, ts
    for i in range(2):
        b = pair_batch(i)
        jp, js, jm_ = jstep(jp, js, b)
        tp, ts, tm = tstep(tp, ts, b)
        pp, ps, pm = plain(pp, ps, b)
        assert_metrics(tm, jm_, "f32")
        assert_params(tp, jp, "f32", i + 1)
        assert abs(float(tm["loss"]) - float(pm["loss"])) <= 1e-5 * abs(float(pm["loss"]))
        assert abs(float(tm["grad_norm"]) - float(pm["grad_norm"])) <= 1e-5 * float(pm["grad_norm"])

"""The port's training (`codegraph_tpu_torch/models/training.py`) held to the
JAX package's (`codegraph_tpu/models/training.py`, jitted, optax) on the CPU.

A small config (hidden 64, 2 layers, 4 heads, vocab 512, L 16, B 8) takes
one set of numpy-seeded parameters into both packages; each step gets the
same batch. Tolerances:

* f32: loss and grad_norm within 1e-5 relative, accuracy equal, the
  gradients within 1e-5 (relative L2 per tensor), the optimizer's updates
  on the same gradients within 1e-6 relative, and after each step all but
  1 in 1,000 parameter entries within 1e-5, every entry within 2 lr per
  step taken: Adam's update g / (|g| + eps) turns a last-bit difference of
  a gradient entry near eps into a visible one (a few hundredths of lr;
  up to lr where the gradient is 0 in exact arithmetic, see
  `assert_params`).
* bf16: loss and grad_norm within one bf16 step of their value (2^-7 of
  its power of two), accuracy within one pair in B, every parameter within
  2.5 lr per step taken, the gradients within 2e-2 (relative L2 per
  tensor). XLA keeps excess precision inside the fused bf16
  forward (see test_torch_encoder), so a few gradient entries near zero
  change sign, and Adam moves each of them lr the other way.

Also: the dense MoE trains, remat gives the same steps bit for bit, the
cross-encoder loss and step (pointwise and listwise at group size 4), the
JAX train state carried across mid-run, save/restore continuing bit-equal,
trained weights read by the JAX package, the refusals (a mesh, item 15;
the routed MoE, item 16), and the three-piece bf16 split that the card's
backward of a tensor-core product uses.
"""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.models import training as jt
from codegraph_tpu.models.encoder import EncoderConfig as JConfig
from codegraph_tpu.models.encoder import encode_jit as jencode
from codegraph_tpu.models.providers import load_encoder_checkpoint as jload
from codegraph_tpu_torch.models import training as tt
from codegraph_tpu_torch.models.encoder import EncoderConfig as TConfig
from codegraph_tpu_torch.models.encoder import (
    encode,
    encoder_params_from_jax,
    pieces_mm,
    split_bf16,
)
from codegraph_tpu_torch.models.providers import save_encoder_checkpoint

from tests.test_torch_encoder import numpy_params

SMALL = dict(vocab_size=512, hidden=64, n_layers=2, n_heads=4, max_len=16)
B, L, LR = 8, 16, 1e-3
F32_REL = 1e-5
F32_PARAM = 1e-5
F32_PARAM_OUTLIERS = 1e-3   # the share of entries allowed past F32_PARAM
BF16_PARAM_PER_STEP = 2.5 * LR
BF16_GRAD_REL = 2e-2        # relative L2 per tensor, bf16 against JAX's fused forward
CPU = torch.device("cpu")


def configs(dtype_name, **kw):
    jd, td = (jnp.float32, torch.float32) if dtype_name == "f32" else (jnp.bfloat16, torch.bfloat16)
    return JConfig(**SMALL, **kw, dtype=jd), TConfig(**SMALL, **kw, dtype=td)


def pair_batch(i, vocab=512):
    """Anchors and positives: the positive is its anchor with a quarter of
    the tokens replaced, so the in-batch accuracy is not trivially 0."""
    r = np.random.default_rng(100 + i)
    a = r.integers(0, vocab, (B, L)).astype(np.int32)
    p = np.where(r.random((B, L)) < 0.25, r.integers(0, vocab, (B, L)), a).astype(np.int32)
    lens = r.integers(4, L + 1, (2, B))
    mask = np.arange(L)[None, None] < lens[..., None]
    return {"anchor_ids": a, "anchor_mask": mask[0], "positive_ids": p, "positive_mask": mask[1]}


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def flat(jtree):
    return encoder_params_from_jax(jax.tree.map(np.asarray, jtree))


def bf16_step(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def assert_metrics(tm, jm, dtype_name):
    tl, jl = float(tm["loss"]), float(jm["loss"])
    tg, jg = float(tm["grad_norm"]), float(jm["grad_norm"])
    if dtype_name == "f32":
        assert abs(tl - jl) <= F32_REL * abs(jl), (tl, jl)
        assert abs(tg - jg) <= F32_REL * abs(jg), (tg, jg)
        assert float(tm["accuracy"]) == float(jm["accuracy"])
    else:
        assert abs(tl - jl) <= bf16_step(jl), (tl, jl)
        assert abs(tg - jg) <= bf16_step(jg), (tg, jg)
        assert abs(float(tm["accuracy"]) - float(jm["accuracy"])) <= 1.0 / B + 1e-7


def assert_params(tp, jp, dtype_name, steps, zero_grad=()):
    """zero_grad: leaves whose gradient is 0 in exact arithmetic, so that
    both sides' gradients are rounding noise near eps and Adam moves each
    entry up to lr either way a step."""
    want = flat(jp)
    assert set(tp) == set(want)
    errs = []
    for k in tp:
        assert tp[k].dtype == torch.float32
        err = (tp[k] - want[k]).abs().flatten()
        if k in zero_grad:
            assert float(err.max()) <= 2 * LR * steps, k
        else:
            errs.append(err)
    err = torch.cat(errs)
    if dtype_name == "f32":
        assert float((err > F32_PARAM).float().mean()) <= F32_PARAM_OUTLIERS
        assert float(err.max()) <= 2 * LR * steps
    else:
        assert float(err.max()) <= BF16_PARAM_PER_STEP * steps


def run_both(jcfg, tcfg, tc, steps, tree=None):
    """`steps` steps of the jitted JAX train_step and of the port's on the
    same batches; yields (i, port state, JAX state) after each."""
    tree = numpy_params(jcfg) if tree is None else tree
    jopt = jt.make_optimizer(tc)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    jstep = jax.jit(partial(jt.train_step, cfg=jcfg, tcfg=tc, optimizer=jopt))
    ttc = tt.TrainConfig(**dataclasses.asdict(tc))
    topt = tt.make_optimizer(ttc)
    tp = encoder_params_from_jax(tree)
    ts = topt.init(tp)
    for i in range(steps):
        b = pair_batch(i, jcfg.vocab_size)
        jp, js, jm = jstep(jp, js, jax_batch(b))
        tp, ts, tm = tt.train_step(tp, ts, b, tcfg, ttc, topt)
        yield i, (tp, ts, tm), (jp, js, jm)


CASES = [(d, s, c) for d in ("f32", "bf16") for s in ("const", "cosine") for c in (1.0, 1e-3)]


@pytest.mark.parametrize("dtype_name,schedule,clip", CASES)
def test_train_step_matches_jax(dtype_name, schedule, clip):
    jcfg, tcfg = configs(dtype_name)
    tc = jt.TrainConfig(learning_rate=LR, schedule=schedule, total_steps=6, warmup_steps=2,
                        grad_clip=clip)
    for i, (tp, ts, tm), (jp, js, jm) in run_both(jcfg, tcfg, tc, steps=4):
        assert ts["count"] == int(js[1][0].count) == i + 1
        assert_metrics(tm, jm, dtype_name)
        assert_params(tp, jp, dtype_name, i + 1)


def test_schedule_matches_optax():
    """The rate at every count, read before the increment, is optax's."""
    tc = jt.TrainConfig(learning_rate=5e-4, schedule="cosine", total_steps=40, warmup_steps=200)
    opt = tt.make_optimizer(tt.TrainConfig(**dataclasses.asdict(tc)))
    import optax

    ref = optax.warmup_cosine_decay_schedule(5e-4 / 25, 5e-4, 4, 40, 5e-4 / 10)
    for count in range(45):
        assert float(opt.learning_rate(count)) == pytest.approx(float(ref(count)), rel=1e-6)
    const = tt.make_optimizer(tt.TrainConfig(learning_rate=5e-4))
    assert float(const.learning_rate(7)) == np.float32(5e-4)


def test_clip_is_optax_not_clip_grad_norm():
    """Below the bound nothing is scaled (clip_grad_norm_ would scale by
    max / (norm + 1e-6)); above it the gradients are scaled by max/norm."""
    opt = tt.make_optimizer(tt.TrainConfig(learning_rate=1.0, weight_decay=0.0, grad_clip=2.0))
    p = {"w": torch.zeros(3)}
    g = {"w": torch.tensor([1.0, 1.0, 0.0])}  # norm sqrt(2) < 2
    st = opt.init(p)
    _, st = opt.update(g, st, p)
    assert torch.equal(st["mu"]["w"], 0.1 * g["w"])
    g = {"w": torch.tensor([3.0, 4.0, 0.0])}  # norm 5
    _, st2 = opt.update(g, opt.init(p), p)
    assert torch.allclose(st2["mu"]["w"], 0.1 * g["w"] * (2.0 / 5.0), rtol=1e-7, atol=0)


def test_dense_moe_trains_like_jax():
    jcfg, tcfg = configs("f32", n_experts=4)
    tc = jt.TrainConfig(learning_rate=LR)
    losses = []
    for i, (tp, ts, tm), (jp, js, jm) in run_both(jcfg, tcfg, tc, steps=3):
        assert_metrics(tm, jm, "f32")
        assert_params(tp, jp, "f32", i + 1)
        losses.append(float(tm["loss"]))
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_remat_gives_the_same_steps(dtype_name):
    _, plain = configs(dtype_name)
    _, remat = configs(dtype_name, remat=True)
    tree = numpy_params(configs(dtype_name)[0])
    ttc = tt.TrainConfig(learning_rate=LR)
    runs = []
    for cfg in (plain, remat):
        opt = tt.make_optimizer(ttc)
        p = encoder_params_from_jax(tree)
        s = opt.init(p)
        ms = []
        for i in range(2):
            p, s, m = tt.train_step(p, s, pair_batch(i), cfg, ttc, opt)
            ms.append(m)
        runs.append((p, ms))
    (p0, m0), (p1, m1) = runs
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_remat_matches_jax_remat():
    jcfg, tcfg = configs("f32", remat=True)
    for i, (tp, ts, tm), (jp, js, jm) in run_both(jcfg, tcfg, jt.TrainConfig(learning_rate=LR),
                                                  steps=2):
        assert_metrics(tm, jm, "f32")
        assert_params(tp, jp, "f32", i + 1)


def ce_batch(n_pairs, group, seed=7, vocab=512):
    r = np.random.default_rng(seed)
    ids = r.integers(0, vocab, (n_pairs, L)).astype(np.int32)
    mask = np.arange(L)[None] < r.integers(5, L + 1, n_pairs)[:, None]
    labels = np.zeros(n_pairs, np.int32)
    if group > 1:
        labels[::group] = 1  # positive first in each group
    else:
        labels[r.random(n_pairs) < 0.5] = 1
    return {"pair_ids": ids, "pair_mask": mask, "labels": labels}


def ce_head(seed=3, hidden=64):
    r = np.random.default_rng(seed)
    return {"w": (r.standard_normal(hidden) / 8).astype(np.float32),
            "b": np.asarray(0.1, np.float32)}


@pytest.mark.parametrize("group", [0, 4])
def test_cross_encoder_loss_and_step_match_jax(group):
    jcfg, tcfg = configs("f32", pooling="cls")
    tree, head = numpy_params(jcfg), ce_head()
    b = ce_batch(8, group)
    jl, jmet = jt.cross_encoder_loss(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, head),
                                     jax_batch(b), jcfg, group_size=group)
    tparams = encoder_params_from_jax(tree)
    thead = {k: torch.from_numpy(np.array(v)) for k, v in head.items()}
    tl, tmet = tt.cross_encoder_loss(tparams, thead, tt._batch_on(b, CPU), tcfg, group_size=group)
    assert abs(float(tl) - float(jl)) <= F32_REL * abs(float(jl))
    assert float(tmet["accuracy"]) == float(jmet["accuracy"])

    tc = jt.TrainConfig(learning_rate=LR)
    jstep, jopt = jt.make_cross_encoder_train_step(jcfg, tc, group_size=group)
    jps = (jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, head))
    jstate = (jps, jopt.init(jps))
    tstep, topt = tt.make_cross_encoder_train_step(tcfg, tt.TrainConfig(**dataclasses.asdict(tc)),
                                                   group_size=group)
    tstate = ((tparams, thead), topt.init((tparams, thead)))
    for i in range(3):
        bi = ce_batch(8, group, seed=20 + i)
        jstate, jm = jstep(jstate, jax_batch(bi))
        tstate, tm = tstep(tstate, bi)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= F32_REL * abs(float(jm["loss"]))
        (jp, jh), _ = jstate
        (tp, th), _ = tstate
        # a listwise loss does not move when every logit moves alike: the
        # final norm's bias and the head's bias get no gradient
        zero = ("ln_out_bias", "b") if group else ()
        assert_params(tp, jp, "f32", i + 1, zero_grad=zero)
        for k in th:
            err = float((th[k] - torch.from_numpy(np.array(jh[k]))).abs().max())
            assert err <= (2 * LR * (i + 1) if k in zero else 1e-5 + 0.1 * LR), (k, err)


def test_train_state_from_jax_continues_equal():
    """Three JAX steps, the state carried across, two more on each side."""
    jcfg, tcfg = configs("f32")
    tc = jt.TrainConfig(learning_rate=LR, schedule="cosine", total_steps=8, warmup_steps=2)
    jopt = jt.make_optimizer(tc)
    jp = jax.tree.map(jnp.asarray, numpy_params(jcfg))
    js = jopt.init(jp)
    jstep = jax.jit(partial(jt.train_step, cfg=jcfg, tcfg=tc, optimizer=jopt))
    for i in range(3):
        jp, js, _ = jstep(jp, js, jax_batch(pair_batch(i)))
    tp, ts = tt.train_state_from_jax(jax.tree.map(np.asarray, jp), js, device="cpu")
    assert ts["count"] == 3
    ttc = tt.TrainConfig(**dataclasses.asdict(tc))
    topt = tt.make_optimizer(ttc)
    for i in range(3, 5):
        b = pair_batch(i)
        jp, js, jm = jstep(jp, js, jax_batch(b))
        tp, ts, tm = tt.train_step(tp, ts, b, tcfg, ttc, topt)
        assert_metrics(tm, jm, "f32")
        assert_params(tp, jp, "f32", i + 1)


def test_train_state_from_jax_cross_encoder_pair():
    jcfg, tcfg = configs("f32", pooling="cls")
    tc = jt.TrainConfig(learning_rate=LR)
    jstep, jopt = jt.make_cross_encoder_train_step(jcfg, tc, group_size=4)
    jps = (jax.tree.map(jnp.asarray, numpy_params(jcfg)), jax.tree.map(jnp.asarray, ce_head()))
    jstate = (jps, jopt.init(jps))
    jstate, _ = jstep(jstate, jax_batch(ce_batch(8, 4)))
    (tparams, thead), ts = tt.train_state_from_jax(jax.tree.map(np.asarray, jstate[0]), jstate[1],
                                                   device="cpu")
    assert ts["count"] == 1 and set(ts["mu"][1]) == {"w", "b"}
    tstep, _ = tt.make_cross_encoder_train_step(tcfg, tt.TrainConfig(**dataclasses.asdict(tc)), 4)
    b = ce_batch(8, 4, seed=30)
    jstate, jm = jstep(jstate, jax_batch(b))
    (tstate, tm) = tstep(((tparams, thead), ts), b)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= F32_REL * abs(float(jm["loss"]))
    assert_params(tstate[0][0], jstate[0][0], "f32", 2, zero_grad=("ln_out_bias",))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_save_restore_continues_bit_equal(tmp_path, dtype_name):
    _, tcfg = configs(dtype_name)
    ttc = tt.TrainConfig(learning_rate=LR, schedule="cosine", total_steps=6, warmup_steps=2)
    step, init = tt.make_sharded_train_step(None, tcfg, ttc, device="cpu")
    p, s = init(torch.Generator().manual_seed(0))
    for i in range(2):
        p, s, _ = step(p, s, pair_batch(i))
    path = str(tmp_path / "state.pt")
    tt.save_train_state(path, p, s, step=2)
    p_ref, s_ref, m_ref = step(p, s, pair_batch(2))
    p2, s2, n = tt.restore_train_state(path, template=p)
    assert n == 2 and s2["count"] == 2
    p_got, s_got, m_got = step(p2, s2, pair_batch(2))
    for k in p_ref:
        assert torch.equal(p_got[k], p_ref[k]), k
        assert torch.equal(s_got["mu"][k], s_ref["mu"][k]) and torch.equal(s_got["nu"][k],
                                                                           s_ref["nu"][k])
    assert all(torch.equal(m_got[k], m_ref[k]) for k in m_ref)


def test_trained_weights_load_in_jax(tmp_path):
    jcfg, tcfg = configs("f32")
    ttc = tt.TrainConfig(learning_rate=LR)
    opt = tt.make_optimizer(ttc)
    p = encoder_params_from_jax(numpy_params(jcfg))
    s = opt.init(p)
    for i in range(3):
        p, s, _ = tt.train_step(p, s, pair_batch(i), tcfg, ttc, opt)
    path = str(tmp_path / "trained.npz")
    save_encoder_checkpoint(path, p, cfg=tcfg)
    b = pair_batch(9)
    want = np.asarray(jencode(jload(path), jnp.asarray(b["anchor_ids"]),
                              jnp.asarray(b["anchor_mask"]), jcfg))
    with torch.inference_mode():
        got = encode(p, torch.from_numpy(b["anchor_ids"]), torch.from_numpy(b["anchor_mask"]),
                     tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mesh_raises_naming_item_15():
    _, tcfg = configs("f32")
    ttc = tt.TrainConfig()
    with pytest.raises(NotImplementedError, match="item 15"):
        tt.make_sharded_train_step(object(), tcfg, ttc, device="cpu")
    with pytest.raises(NotImplementedError, match="item 15"):
        tt.make_sharded_train_step(object(), tcfg, ttc, sp_axis="sp", device="cpu")
    p, s = tt.make_sharded_train_step(None, tcfg, ttc, device="cpu")[1](torch.Generator())
    with pytest.raises(NotImplementedError, match="item 15"):
        tt.train_step(p, s, pair_batch(0), tcfg, ttc, tt.make_optimizer(ttc), mesh=object())


def test_routed_moe_raises_naming_item_16():
    _, tcfg = configs("f32", n_experts=4, moe_top_k=2)
    with pytest.raises(NotImplementedError, match="item 16"):
        tt.make_sharded_train_step(None, tcfg, tt.TrainConfig(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 16"):
        tt.make_cross_encoder_train_step(tcfg, tt.TrainConfig())


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    _, tcfg = configs("f32")
    with pytest.raises(RuntimeError, match="cuda"):
        tt.make_sharded_train_step(None, tcfg, tt.TrainConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        tt.train_state_from_jax({}, ())


def test_split_bf16_is_exact(rng):
    t = torch.from_numpy((rng.standard_normal(4096) * 10.0 ** rng.integers(-20, 20, 4096))
                         .astype(np.float32))
    hi, mid, lo = split_bf16(t)
    assert hi.dtype == torch.bfloat16
    assert torch.equal(hi.float() + mid.float() + lo.float(), t)


@pytest.mark.parametrize("batched", [False, True])
def test_three_piece_products_equal_the_f32_product(rng, batched):
    """The card's backward of a tensor-core product (f32 cotangent x bf16
    operand as three bf16 pieces) computes the f32 product of the CPU
    route, run here with the CPU's exact bf16 product in place of the
    tensor cores."""
    shape = (3,) if batched else ()
    f = torch.from_numpy(rng.standard_normal(shape + (17, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(shape + (40, 9)).astype(np.float32)).bfloat16()
    w2 = torch.from_numpy(rng.standard_normal(shape + (9, 17)).astype(np.float32)).bfloat16()
    def exact(a, b, acc=None):  # the CPU's exact bf16 product, summed in f32
        out = torch.matmul(a.float(), b.float())
        return out if acc is None else acc + out

    pieces = split_bf16(f)
    for got, a, b in ((pieces_mm(pieces, w, mm=exact), f, w),
                      (pieces_mm(pieces, w2, pieces_left=False, mm=exact), w2, f)):
        want = torch.matmul(a.double(), b.double())
        # three f32 sums of K exact products, added: within 3K * 2^-24 of
        # the sum of |terms|
        bound = 3 * a.shape[-1] * 2.0 ** -24 * torch.matmul(a.double().abs(), b.double().abs())
        assert bool(((got.double() - want).abs() <= bound).all())


def test_optimizer_updates_match_optax(rng):
    """On the same gradients (large, tiny and zero entries; above and
    below the clip), both schedules: updates and moments within 1e-6."""
    import optax

    shapes = {"a": (5, 7), "b": (11,), "c": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}
    for schedule, clip in (("const", 1e6), ("cosine", 1e-2)):
        tc = jt.TrainConfig(learning_rate=LR, schedule=schedule, total_steps=6, warmup_steps=2,
                            grad_clip=clip)
        jopt, topt = jt.make_optimizer(tc), tt.make_optimizer(tt.TrainConfig(**dataclasses.asdict(tc)))
        js = jopt.init(jax.tree.map(jnp.asarray, params))
        tp = {k: torch.from_numpy(v) for k, v in params.items()}
        ts = topt.init(tp)
        for i in range(5):
            g = {k: np.asarray(rng.standard_normal(s) * 10.0 ** rng.integers(-9, 1, s),
                               np.float32) for k, s in shapes.items()}
            ju, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jax.tree.map(jnp.asarray, params))
            tu, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
            for k in shapes:
                np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6, atol=1e-12)
                np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js[1][0].nu[k]),
                                           rtol=1e-6, atol=0)
            assert float(tt.global_norm(tu)) == pytest.approx(float(optax.global_norm(ju)),
                                                              rel=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the tensor-core products have no CPU route")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tensor_core_backward_matches_cpu(cuda_device):
    """A bf16 step on the card against the CPU route on the same weights."""
    _, tcfg = configs("bf16")
    ttc = tt.TrainConfig(learning_rate=LR)
    tree = numpy_params(configs("bf16")[0])
    out = {}
    for dev in (CPU, cuda_device):
        p = {k: v.to(dev) for k, v in encoder_params_from_jax(tree).items()}
        _, _, grads = tt._value_and_grad(
            lambda q: tt.info_nce_loss(q, tt._batch_on(pair_batch(0), dev), tcfg, 0.05), p)
        out[dev.type] = {k: g.cpu() for k, g in grads.items()}
    for k, g in out["cpu"].items():
        rel = float((out["cuda"][k] - g).norm() / g.norm().clamp(min=1e-12))
        assert rel < 2e-2, (k, rel)


def _grads_both(dtype_name, **kw):
    jcfg, tcfg = configs(dtype_name, **kw)
    tree, b = numpy_params(jcfg), pair_batch(0)
    jg = jax.jit(jax.grad(lambda p: jt.info_nce_loss(p, jax_batch(b), jcfg, 0.05)[0]))(
        jax.tree.map(jnp.asarray, tree))
    _, _, tg = tt._value_and_grad(
        lambda p: tt.info_nce_loss(p, tt._batch_on(b, CPU), tcfg, 0.05), encoder_params_from_jax(tree))
    return tg, flat(jg)


@pytest.mark.parametrize("dtype_name,tol", [("f32", 1e-5), ("bf16", BF16_GRAD_REL)])
def test_gradients_match_jax(dtype_name, tol):
    tg, jg = _grads_both(dtype_name)
    for k in tg:
        rel = float((tg[k] - jg[k]).norm() / jg[k].norm())
        assert rel <= tol, (k, rel)

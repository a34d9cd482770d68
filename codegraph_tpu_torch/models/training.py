"""Port of `codegraph_tpu/models/training.py`: contrastive (InfoNCE) and
cross-encoder training of the encoder, in PyTorch under the JAX names.

Reference: crates/codegraph-vector/src/ml/training.rs (953 LoC of
host-side training loop skeleton). One step runs the encoder forward on
the anchor and positive batches, the symmetric in-batch-negatives loss
over `za @ zp.T`, the backward through autograd (the encoder's bf16
tensor-core products carry their own backward, models/encoder.py
`_TensorCoreMM`), and the optimizer.

The optimizer is the JAX package's optax chain written out
(`make_optimizer` -> `AdamW`): `clip_by_global_norm` (the gradients are
scaled by max/norm only when the norm exceeds max, with no epsilon; so not
`torch.nn.utils.clip_grad_norm_`, which divides by norm + 1e-6), then
`adamw` (b1 0.9, b2 0.999, eps 1e-8, weight decay on every leaf: biases,
norms and embeddings too) at a constant rate or optax's
`warmup_cosine_decay_schedule`, read at the step count before its
increment. `grad_norm` is the norm of the raw gradients. The arithmetic
follows optax's in f32, so an f32 step equals the JAX step up to the
order of f32 sums.

Parameters are the encoder's flat dict of tensors (`models/encoder.py`);
a cross-encoder's are the pair (encoder params, head {"w": [H], "b": []}).
The optimizer state is {"count": int, "mu": <params' structure>, "nu":
...}; `train_state_from_jax` carries a JAX parameter tree and optax state
across. Steps return new parameter tensors and leave their inputs as they
were.

Deliberate differences (ROADMAP section 3): `make_sharded_train_step`
takes no mesh (a mesh raises, ROADMAP item 15; the routed mixture of
experts raises, item 16); the train state is saved
with `torch.save` to one file, not with orbax to a directory, and the
port reads no orbax checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from codegraph_tpu_torch.models.encoder import (
    EncoderConfig,
    encode,
    encoder_params_from_jax,
    init_encoder_params,
)

Tree = object  # a tensor, or a dict / tuple of trees


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    temperature: float = 0.05
    grad_clip: float = 1.0
    # "const" | "cosine" (linear warmup -> cosine decay to lr/10; set
    # total_steps for the decay horizon)
    schedule: str = "const"
    total_steps: int = 0
    warmup_steps: int = 200


# -- trees ---------------------------------------------------------------


def _leaves(tree: Tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def global_norm(tree: Tree) -> torch.Tensor:
    """optax.global_norm: sqrt of the sum of every leaf's squares."""
    return torch.sqrt(sum(torch.sum(t * t) for t in _leaves(tree)))


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


# -- optimizer -----------------------------------------------------------


class AdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(lr, weight_decay))
    of `TrainConfig`: init(params) -> state; update(grads, state, params)
    -> (updates, state); `apply_updates` adds the updates."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tcfg: TrainConfig):
        self.tcfg = tcfg
        self.cosine = tcfg.schedule == "cosine" and tcfg.total_steps > 0
        if self.cosine:
            self.warmup = min(tcfg.warmup_steps, max(1, tcfg.total_steps // 10))

    def init(self, params: Tree) -> dict:
        zeros = lambda p: torch.zeros_like(p, memory_format=torch.contiguous_format)
        return {"count": 0, "mu": _map(zeros, params), "nu": _map(zeros, params)}

    def learning_rate(self, count: int) -> torch.Tensor:
        """The rate at step `count` (0 for the first step), in f32 as optax
        computes it: linear from lr/25 to lr over the warmup, then a cosine
        down to lr/10 at total_steps, then flat."""
        lr = self.tcfg.learning_rate
        if not self.cosine:
            return _f32(lr)
        init, end = lr / 25.0, lr / 10.0
        w = self.warmup
        if count < w:  # optax.linear_schedule(init, lr, w)
            frac = 1 - _f32(min(max(count, 0), w)) / w
            return _f32(init - lr) * frac + _f32(lr)
        # optax.cosine_decay_schedule(lr, total - w, alpha=end / lr)
        decay_steps = float(self.tcfg.total_steps - w)
        alpha = end / lr
        t = torch.minimum(_f32(count - w), _f32(decay_steps))
        cosine = 0.5 * (1 + torch.cos(_f32(math.pi) * t / decay_steps))
        return lr * ((1 - alpha) * cosine + alpha)

    def update(self, grads: Tree, state: dict, params: Tree) -> Tuple[Tree, dict]:
        tc = self.tcfg
        g_norm = global_norm(grads)
        keep = g_norm < tc.grad_clip
        grads = _map(lambda t: torch.where(keep, t, (t / g_norm.to(t.dtype)) * tc.grad_clip),
                     grads)
        b1, b2 = self.b1, self.b2
        mu = _map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = _map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state["nu"])
        count = state["count"] + 1
        # the bias corrections and the signed rate in f32, sent to the
        # device in one copy; pow with an f32 exponent is powf, as XLA's
        # (an int exponent multiplies out, 1 ulp off, and 1 - b2**count
        # turns that ulp into 1e-5 of the result)
        scalars = torch.stack((1 - _f32(b1) ** _f32(count), 1 - _f32(b2) ** _f32(count),
                               -self.learning_rate(state["count"])))
        bc1, bc2, step = scalars.to(_leaves(params)[0].device)

        def one(m, v, p):
            m_hat = m / bc1.to(m.dtype)
            v_hat = v / bc2.to(v.dtype)
            u = m_hat / (torch.sqrt(v_hat + 0.0) + self.eps)
            u = u + tc.weight_decay * p
            return step.to(u.dtype) * u

        updates = _map(one, mu, nu, params)
        return updates, {"count": count, "mu": mu, "nu": nu}


def apply_updates(params: Tree, updates: Tree) -> Tree:
    """optax.apply_updates: p + u in p's dtype."""
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)


def make_optimizer(tcfg: TrainConfig) -> AdamW:
    return AdamW(tcfg)


# -- losses --------------------------------------------------------------


def _no_mesh(mesh) -> None:
    """Without a mesh the axis names mean nothing, as in the JAX package."""
    if mesh is not None:
        raise NotImplementedError(
            "sharded training (a mesh, and dp/sp/ep axes on it) is not ported yet: "
            "ROADMAP item 15; the port trains on one device")


def _check_cfg(cfg: EncoderConfig) -> None:
    if cfg.n_experts > 0 and cfg.moe_top_k > 0:
        raise NotImplementedError(
            "the routed mixture of experts (moe_top_k > 0) is not ported yet: "
            "ROADMAP item 16; use moe_top_k=0 (dense dispatch)")


def _softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels over the last axis."""
    logits = logits - logits.amax(dim=-1, keepdim=True).detach()
    label_logits = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.log(torch.exp(logits).sum(dim=-1)) - label_logits


def info_nce_loss(
    params, batch: Dict[str, torch.Tensor], cfg: EncoderConfig, temperature: float,
    mesh=None, dp_axis=None, sp_axis=None, ep_axis=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Symmetric InfoNCE over in-batch negatives.

    batch: anchor_ids/anchor_mask/positive_ids/positive_mask, all [B, L]
    tensors on the parameters' device."""
    _no_mesh(mesh)
    za = encode(params, batch["anchor_ids"], batch["anchor_mask"], cfg)
    zp = encode(params, batch["positive_ids"], batch["positive_mask"], cfg)
    logits = (za @ zp.T) / temperature  # [B, B]
    labels = torch.arange(za.shape[0], device=za.device)
    loss_a = _softmax_ce(logits, labels)
    loss_p = _softmax_ce(logits.T, labels)
    loss = torch.mean(loss_a + loss_p) * 0.5
    acc = torch.mean((torch.argmax(logits, dim=-1) == labels).float())
    return loss, {"loss": loss, "accuracy": acc}


def _device_of(params: Tree) -> torch.device:
    return _leaves(params)[0].device


def _batch_on(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v).to(device)
            for k, v in batch.items()}


def _value_and_grad(loss_fn: Callable, params: Tree):
    """(loss, metrics, grads) of loss_fn(params) -> (loss, metrics); a
    parameter the loss does not read gets a zero gradient."""
    live = _map(lambda p: p.detach().requires_grad_(True), params)
    leaves = _leaves(live)
    loss, metrics = loss_fn(live)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
    return loss, metrics, _map(lambda _: next(it), live)


def train_step(
    params, opt_state, batch, cfg: EncoderConfig, tcfg: TrainConfig, optimizer: AdamW,
    mesh=None, dp_axis=None, sp_axis=None, ep_axis=None,
):
    """One step -> (params, opt_state, metrics {loss, accuracy,
    grad_norm} as 0-dim tensors on the parameters' device)."""
    _no_mesh(mesh)
    batch = _batch_on(batch, _device_of(params))
    _, metrics, grads = _value_and_grad(
        lambda p: info_nce_loss(p, batch, cfg, tcfg.temperature), params)
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
    return params, opt_state, metrics


def make_sharded_train_step(
    mesh,
    cfg: EncoderConfig,
    tcfg: TrainConfig,
    dp_axis: str = "dp",
    sp_axis: Optional[str] = None,
    ep_axis: Optional[str] = None,
    device="cuda",
):
    """The JAX package compiles the step over a (dp, tp[, sp|ep]) mesh;
    the port runs it on one device, so `mesh` must be None (the axis
    names then mean nothing). Returns (step_fn, init_fn):
    init_fn(generator) draws f32 parameters on `device` and the optimizer
    state; step_fn(params, opt_state, batch) runs one step."""
    from codegraph_tpu_torch.index.flat import resolve_device

    _no_mesh(mesh)
    _check_cfg(cfg)
    dev = resolve_device(device)
    optimizer = make_optimizer(tcfg)

    def init_fn(generator: torch.Generator):
        params = {k: v.to(dev) for k, v in init_encoder_params(cfg, generator).items()}
        return params, optimizer.init(params)

    def step_fn(params, opt_state, batch):
        return train_step(params, opt_state, batch, cfg, tcfg, optimizer)

    return step_fn, init_fn


def cross_encoder_loss(
    params, head, batch: Dict[str, torch.Tensor], cfg: EncoderConfig,
    group_size: int = 0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss for the cross-encoder reranker (models/cross_encoder.py):
    batch carries tokenized (query+doc) pairs (pair_ids/pair_mask) and 0/1
    relevance labels.

    With group_size G > 1 the batch is G consecutive candidates per
    query (positive first) and the loss is LISTWISE softmax-CE over
    each group; `accuracy` is group-argmax==positive (chance = 1/G).
    Otherwise pointwise sigmoid BCE (which an all-negative predictor
    already scores (G-1)/G "accuracy" on 1-in-G data)."""
    cls = encode(params, batch["pair_ids"], batch["pair_mask"], cfg, normalize=False)
    logits = cls @ head["w"].to(cls.dtype) + head["b"].to(cls.dtype)
    labels = batch["labels"].float()
    if group_size and group_size > 1:
        g = logits.reshape(-1, group_size)
        pos = labels.reshape(-1, group_size).argmax(dim=1)
        logp = torch.log_softmax(g, dim=1)
        loss = -torch.mean(torch.gather(logp, 1, pos[:, None]))
        acc = torch.mean((g.argmax(dim=1) == pos).float())
    else:
        # optax.sigmoid_binary_cross_entropy
        bce = -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)
        loss = torch.mean(bce)
        acc = torch.mean(((logits > 0) == (labels > 0.5)).float())
    return loss, {"loss": loss, "accuracy": acc}


def make_cross_encoder_train_step(cfg: EncoderConfig, tcfg: TrainConfig,
                                  group_size: int = 0):
    """Single-device train step over (encoder params, head). Returns
    (step_fn, optimizer) — step_fn(state, batch) -> (state, metrics)
    where state = ((params, head), opt_state) and opt_state =
    optimizer.init((params, head)). group_size > 0 trains listwise over
    groups of G consecutive candidates per query (see
    cross_encoder_loss)."""
    _check_cfg(cfg)
    optimizer = make_optimizer(tcfg)

    def step(state, batch):
        (params, head), opt_state = state
        batch = _batch_on(batch, _device_of(params))
        _, metrics, grads = _value_and_grad(
            lambda ph: cross_encoder_loss(ph[0], ph[1], batch, cfg, group_size=group_size),
            (params, head))
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, (params, head))
            params, head = apply_updates((params, head), updates)
            metrics = {k: v.detach() for k, v in metrics.items()}
        return ((params, head), opt_state), metrics

    return step, optimizer


# -- train state ---------------------------------------------------------


def save_train_state(path: str, params, opt_state, step: int) -> None:
    """Checkpoint the full train state to one file (`torch.save`; the JAX
    package writes an orbax directory, which the port does not read)."""
    torch.save({"params": params, "opt_state": opt_state, "step": int(step)}, path)


def restore_train_state(path: str, template=None):
    """-> (params, opt_state, step). Pass `template` (a matching params
    tree, e.g. a fresh init) to load onto its device; without one the
    tensors load where they were saved."""
    device = _leaves(template)[0].device if template is not None else None
    state = torch.load(path, map_location=device, weights_only=True)
    return state["params"], state["opt_state"], int(state["step"])


def _tree_from_jax(tree) -> Tree:
    """A JAX params tree (numpy or JAX arrays) as the port's: an encoder
    tree becomes the flat dict, a tuple maps element by element, any other
    dict maps leaf by leaf."""
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_from_jax(t) for t in tree)
    if isinstance(tree, dict) and "tok_emb" in tree:
        return encoder_params_from_jax(tree)
    if isinstance(tree, dict):
        return {k: _tree_from_jax(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _adam_state(opt_state):
    """The (count, mu, nu) leaf of an optax chain's state, found by its
    fields (optax itself is not imported)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def train_state_from_jax(params, opt_state, device="cuda") -> Tuple[Tree, dict]:
    """The JAX package's train state (a parameter tree, or the
    cross-encoder's (params, head) pair, and the optax state of
    `make_optimizer`) as the port's (params, opt_state) on `device`:
    optax's first and second moments and its step count. The schedule's
    own count equals Adam's in a run from `optimizer.init`."""
    from codegraph_tpu_torch.index.flat import resolve_device

    dev = resolve_device(device)
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optax state given")
    to = lambda t: t.to(dev)
    state = {"count": int(np.asarray(adam.count)),
             "mu": _map(to, _tree_from_jax(adam.mu)),
             "nu": _map(to, _tree_from_jax(adam.nu))}
    return _map(to, _tree_from_jax(params)), state


__all__ = [
    "TrainConfig",
    "AdamW",
    "make_optimizer",
    "apply_updates",
    "global_norm",
    "info_nce_loss",
    "train_step",
    "make_sharded_train_step",
    "cross_encoder_loss",
    "make_cross_encoder_train_step",
    "save_train_state",
    "restore_train_state",
    "train_state_from_jax",
]

"""Port of `codegraph_tpu/parallel/moe.py`: top-k-routed mixture of experts
with all-to-all expert parallelism.

Switch/GShard-style routing with capacity-bounded dispatch buffers:
  1. gate: scores = x @ gate -> top-k experts (a tie goes to the lower
     expert, as `lax.top_k`) and their weights renormalised by a softmax;
  2. dispatch: tokens packed into [E, C, H] by expert, each at the slot of
     its arrival in token-major order (a cumulative count); tokens past
     capacity C drop (Switch semantics) into a scratch slot that is cut off;
  3. all_to_all over the ep shards: [E, C, H] -> [E_local, P*C, H], so each
     shard receives exactly the tokens routed to its experts;
  4. the expert MLP on each shard's experts;
  5. the reverse all_to_all and the weighted combine back in token order.

With a capacity that drops nothing the result equals the dense top-k
oracle (`topk_moe_dense`). Everything is f32 PyTorch; gradients flow
through the scatter, the gathers and the collectives (`parallel/mesh.py`).
Parameters are a dict of tensors ("gate", "w_up_e", "b_up_e", "w_down_e",
"b_down_e"); `moe_params_from_jax` carries the JAX package's across.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from codegraph_tpu_torch.parallel.mesh import Mesh, all_to_all, split_rows

Params = Dict[str, torch.Tensor]

EXPERT_KEYS = ("w_up_e", "b_up_e", "w_down_e", "b_down_e")


def init_moe_params(generator: torch.Generator, hidden: int, mlp_hidden: int,
                    n_experts: int) -> Params:
    """Random f32 parameters with the JAX package's shapes and scales (its
    `jax.random` draws cannot be reproduced: carry one set across with
    `moe_params_from_jax` to hold the two to each other)."""
    s = 1.0 / math.sqrt(hidden)
    return {
        "gate": torch.randn((hidden, n_experts), generator=generator) * s,
        "w_up_e": torch.randn((n_experts, hidden, mlp_hidden), generator=generator) * s,
        "b_up_e": torch.zeros(n_experts, mlp_hidden),
        "w_down_e": torch.randn((n_experts, mlp_hidden, hidden), generator=generator)
        / math.sqrt(mlp_hidden),
        "b_down_e": torch.zeros(n_experts, hidden),
    }


def moe_params_from_jax(params: Mapping) -> Params:
    """The JAX package's MoE parameter dict (leaves as numpy or JAX arrays)
    as CPU tensors, each keeping its dtype."""
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _expert_mlp(x, w_up, b_up, w_down, b_down):
    """[E, C, H] through each expert's MLP: f32 products, tanh GELU."""
    h = torch.matmul(x.float(), w_up.float())
    h = F.gelu(h + b_up[:, None, :], approximate="tanh")
    y = torch.matmul(h, w_down.float())
    return y + b_down[:, None, :]


def topk_experts(scores: torch.Tensor, k: int):
    """`lax.top_k` over the expert axis: (values, experts), a tie to the
    lower expert (a stable descending sort)."""
    top_s, top_e = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top_s[..., :k], top_e[..., :k]


def topk_moe_dense(x: torch.Tensor, params: Params, k: int = 2) -> torch.Tensor:
    """Oracle: top-k routing computed densely (every expert runs every
    token; the others are masked out). The dispatched path's result at a
    capacity that drops nothing."""
    T, H = x.shape
    E = params["gate"].shape[1]
    scores = x @ params["gate"]                        # [T, E]
    top_s, top_e = topk_experts(scores, k)            # [T, k]
    w = torch.softmax(top_s, dim=-1)
    y_all = _expert_mlp(x[None].expand(E, T, H), *(params[n] for n in EXPERT_KEYS))  # [E, T, H]
    sel = F.one_hot(top_e, E).to(x.dtype)             # [T, k, E]
    return torch.einsum("tk,tke,eth->th", w, sel, y_all)


def _dispatch_indices(top_e: torch.Tensor, k: int, E: int, C: int):
    """-> (pos [..., T, k] slot within its expert's buffer, keep [..., T, k]
    mask): the arrival order of the token-major (t, j) pairs at each expert,
    a group of T tokens per leading index of top_e [..., T, k]."""
    flat_e = top_e.reshape(*top_e.shape[:-2], -1)      # [..., T*k], token-major
    onehot = F.one_hot(flat_e, E)                      # [..., T*k, E]
    pos_in_e = torch.cumsum(onehot, dim=-2) - 1
    pos = torch.gather(pos_in_e, -1, flat_e[..., None])[..., 0]
    keep = pos < C
    return pos.reshape(top_e.shape), keep.reshape(top_e.shape)


def capacity(capacity_factor: float, T: int, k: int, E: int) -> int:
    """Buffer slots per expert: max(1, ceil(capacity_factor * T * k / E))."""
    return max(1, int(np.ceil(capacity_factor * T * k / E)))


def _route(x: torch.Tensor, gate: torch.Tensor, k: int, capacity_factor: float):
    """Gate, top-k, capacity and slots of one token group [T, H]:
    (w [T, k], e_idx [T*k], c_idx [T*k], keep [T*k], C)."""
    T = x.shape[0]
    E = gate.shape[1]
    top_s, top_e = topk_experts(x @ gate, k)
    w = torch.softmax(top_s, dim=-1)
    C = capacity(capacity_factor, T, k, E)
    pos, keep = _dispatch_indices(top_e, k, E, C)
    return w, top_e.reshape(-1), pos.reshape(-1), keep.reshape(-1), C


def _pack(x, e_idx, c_idx, keep, E: int, C: int, k: int) -> torch.Tensor:
    """dispatch[e, c] = x[t] for each kept (t, j) routed to (e, c); dropped
    pairs land in the scratch slot C, which is cut off."""
    T, H = x.shape
    t_idx = torch.arange(T, device=x.device).repeat_interleave(k)
    slot = torch.where(keep, c_idx, C)
    buf = torch.zeros((E, C + 1, H), dtype=x.dtype, device=x.device)
    buf = buf.index_put((e_idx, slot), x[t_idx] * keep[:, None].to(x.dtype), accumulate=True)
    return buf[:, :C]


def _combine(y, e_idx, c_idx, keep, w, C: int, k: int, dtype) -> torch.Tensor:
    """Token t reads its k slots, weighted; dropped slots contribute 0."""
    T = w.shape[0]
    gathered = y[e_idx, torch.clamp(c_idx, max=C - 1)]          # [T*k, H]
    wk = (w.reshape(-1) * keep.to(w.dtype))[:, None]
    return (gathered * wk).reshape(T, k, -1).sum(dim=1).to(dtype)


def topk_moe_dispatch(x: torch.Tensor, params: Params, k: int = 2,
                      capacity_factor: float = 2.0) -> torch.Tensor:
    """Capacity-bounded dispatched top-k MoE over all of params' experts on
    one device (the JAX function's ep_size=1 form; `make_sharded_topk_moe`
    is its ep form). x: [T, H]."""
    E = params["gate"].shape[1]
    w, e_idx, c_idx, keep, C = _route(x, params["gate"], k, capacity_factor)
    buf = _pack(x, e_idx, c_idx, keep, E, C, k)
    y = _expert_mlp(buf, *(params[n] for n in EXPERT_KEYS))      # [E, C, H]
    return _combine(y, e_idx, c_idx, keep, w, C, k, x.dtype)


def make_sharded_topk_moe(mesh: Mesh, ep_axis: str = "ep", k: int = 2,
                          capacity_factor: float = 2.0):
    """-> fn(x [T, H], params) computing the routed MoE with all-to-all
    dispatch over the `ep_axis` shards of `mesh`.

    Layout: tokens split over ep in contiguous chunks (T % ep == 0), the
    gate replicated, each expert weight's expert dim split over ep. Each
    shard routes its own tokens (capacity from its T / ep tokens), sends
    every expert's slots to the expert's shard, runs its experts and sends
    the results back. Returns [T, H] on the mesh's first device."""
    devs = mesh.axis_devices(ep_axis)
    P = len(devs)

    def fwd(x: torch.Tensor, params: Params) -> torch.Tensor:
        T, H = x.shape
        E = params["gate"].shape[1]
        if T % P or E % P:
            raise ValueError(f"tokens ({T}) and experts ({E}) must divide by ep={P}")
        xs = split_rows(x, devs)
        experts = {n: split_rows(params[n], devs) for n in EXPERT_KEYS}
        routes, bufs = [], []
        for xl, dev in zip(xs, devs):
            r = _route(xl, params["gate"].to(dev), k, capacity_factor)
            routes.append(r)
            w, e_idx, c_idx, keep, C = r
            bufs.append(_pack(xl, e_idx, c_idx, keep, E, C, k))
        # [E, C, H] -> [E_local, P*C, H]: each shard receives its experts' slots
        bufs = all_to_all(bufs, split_axis=0, concat_axis=1)
        ys = [_expert_mlp(b, *(experts[n][s] for n in EXPERT_KEYS)) for s, b in enumerate(bufs)]
        ys = all_to_all(ys, split_axis=1, concat_axis=0)              # back to [E, C, H]
        outs = [_combine(y, e_idx, c_idx, keep, w, C, k, x.dtype).to(mesh.first_device)
                for y, (w, e_idx, c_idx, keep, C) in zip(ys, routes)]
        return torch.cat(outs)

    return fwd


__all__ = [
    "init_moe_params",
    "moe_params_from_jax",
    "topk_moe_dense",
    "topk_moe_dispatch",
    "make_sharded_topk_moe",
]

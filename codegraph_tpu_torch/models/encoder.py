"""Port of `codegraph_tpu/models/encoder.py`: the transformer text encoder
in PyTorch.

The same forward pass and the same casts as the JAX package's `encode`:
token and position embeddings are added in the parameters' own dtype and
then cast to `cfg.dtype` (bf16 by default); every product takes operands
of `cfg.dtype` and sums them in f32 (the JAX einsums'
`preferred_element_type=f32`); biases, GELU, layer norms and the softmax
run in f32, and each sub-block rounds to `cfg.dtype` once. The attention
mask is an additive f32 bias of -1e30, so a fully padded row has a uniform
softmax, a zero mean pool and a zero embedding (no NaN).

The stacked per-layer tensors (leading dim n_layers) run in a Python loop
over depth. Parameters are a flat dict: the top-level leaves of the JAX
tree under their own names and the per-layer leaves as "layers.<name>";
`encoder_params_from_jax` carries a JAX parameter tree (numpy arrays, as
`load_encoder_checkpoint_ex` returns it) across with each array's dtype.

The forward is differentiable (models/training.py trains through it;
serving callers run it under `torch.inference_mode()`), and `cfg.remat`
recomputes each layer's activations in the backward pass
(`torch.utils.checkpoint`, the JAX package's `jax.checkpoint` per layer).
The bf16 tensor-core products on a CUDA device have no autograd formula
in PyTorch, so `_mm` carries its own backward (`_TensorCoreMM`), the JAX
transpose rule of a bf16 x bf16 -> f32 product.

The mixture of experts runs dense (`moe_top_k == 0`: every expert on every
token) or routed (`_moe_mlp_routed`: top-k experts per token into
capacity-bounded buffers, a group per batch row). With a `mesh`, `encode`
runs across the mesh's devices (`parallel/sharded_encode.py`: the batch
over dp, the sequence over sp, heads and MLP columns over "tp", experts
over ep) and computes what it computes without one;
`encoder_param_shardings` gives each parameter's layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from codegraph_tpu_torch.ops.bf16_split import split_bf16

Params = Dict[str, torch.Tensor]

#: per-layer leaves, stored under "layers.<name>" with leading dim n_layers
LAYER_PREFIX = "layers."


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 512        # byte tokenizer: 256 bytes + specials, padded
    hidden: int = 384
    n_layers: int = 6
    n_heads: int = 12
    mlp_ratio: int = 4
    max_len: int = 512
    pooling: str = "mean"        # mean | cls | max
    n_experts: int = 0           # >0 switches the MLP to a mixture of experts
    moe_top_k: int = 0           # 0: dense dispatch; >0: top-k routed dispatch
    moe_capacity: float = 2.0    # routed only: expert buffer slots per group
                                 # = ceil(moe_capacity * k * L / E)
    remat: bool = False          # recompute layer activations in the backward
    norm_style: str = "pre"      # pre (native) | post (BERT-family imports)
    attn_bias: bool = False      # qkv/output projection biases (BERT has them)
    act: str = "gelu_tanh"       # gelu_tanh (native) | gelu_exact (BERT erf)
    dtype: torch.dtype = torch.bfloat16
    eps: float = 1e-6

    def __post_init__(self):
        if self.hidden % self.n_heads != 0:
            raise ValueError(
                f"hidden={self.hidden} not divisible by n_heads={self.n_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.hidden // self.n_heads

    @property
    def mlp_hidden(self) -> int:
        return self.hidden * self.mlp_ratio


def init_encoder_params(cfg: EncoderConfig, generator: torch.Generator) -> Params:
    """Random f32 parameters with the JAX package's shapes and scales
    (normal / sqrt(fan_in), unit norm scales, zero biases), drawn from
    `generator`. They cannot equal `jax.random`'s draws: to hold the two
    packages to each other, carry one set across with
    `encoder_params_from_jax`."""
    H, Fh, L = cfg.hidden, cfg.mlp_hidden, cfg.n_layers

    def dense(shape, fan_in):
        return torch.randn(shape, generator=generator) / math.sqrt(fan_in)

    layers: Params = {
        "ln1_scale": torch.ones(L, H),
        "ln1_bias": torch.zeros(L, H),
        "wqkv": dense((L, H, 3 * H), H),
        "wo": dense((L, H, H), H),
        "ln2_scale": torch.ones(L, H),
        "ln2_bias": torch.zeros(L, H),
    }
    if cfg.attn_bias:
        layers["b_qkv"] = torch.zeros(L, 3 * H)
        layers["b_o"] = torch.zeros(L, H)
    if cfg.n_experts > 0:
        E = cfg.n_experts
        layers.update({
            "gate": dense((L, H, E), H),
            "w_up_e": dense((L, E, H, Fh), H),
            "b_up_e": torch.zeros(L, E, Fh),
            "w_down_e": dense((L, E, Fh, H), Fh),
            "b_down_e": torch.zeros(L, E, H),
        })
    else:
        layers.update({
            "w_up": dense((L, H, Fh), H),
            "b_up": torch.zeros(L, Fh),
            "w_down": dense((L, Fh, H), Fh),
            "b_down": torch.zeros(L, H),
        })
    params: Params = {
        "tok_emb": dense((cfg.vocab_size, H), H),
        "pos_emb": dense((cfg.max_len, H), H),
        "ln_in_scale": torch.ones(H),
        "ln_in_bias": torch.zeros(H),
        "ln_out_scale": torch.ones(H),
        "ln_out_bias": torch.zeros(H),
    }
    params.update({LAYER_PREFIX + k: v for k, v in layers.items()})
    return params


def encoder_params_from_jax(params: Mapping) -> Params:
    """The JAX package's parameter tree ({"tok_emb": ..., "layers":
    {"wqkv": ...}}, leaves as numpy arrays) as this module's flat dict of
    CPU tensors, each keeping its array's dtype (the shipped checkpoints
    are float16; nothing is upcast)."""
    out: Params = {}
    for key, leaf in params.items():
        if key == "layers":
            out.update({LAYER_PREFIX + k: torch.from_numpy(np.array(v))
                        for k, v in leaf.items()})
        else:
            out[key] = torch.from_numpy(np.array(leaf))
    return out


def encoder_params_to_jax(params: Params) -> Dict:
    """The inverse of `encoder_params_from_jax`: the nested tree of numpy
    arrays that the JAX package's checkpoint keys describe."""
    tree: Dict = {"layers": {}}
    for key, value in params.items():
        arr = value.detach().cpu().numpy()
        if key.startswith(LAYER_PREFIX):
            tree["layers"][key[len(LAYER_PREFIX):]] = arr
        else:
            tree[key] = arr
    return tree


def encoder_param_shardings(cfg: EncoderConfig) -> Dict[str, Tuple]:
    """Each parameter's layout on a mesh, keyed like the parameters: a tuple
    with one mesh axis name (or None: not sharded) per dimension, the JAX
    package's PartitionSpecs. tp: column-parallel wqkv/w_up (output
    features, i.e. heads), row-parallel wo/w_down (input features); ep: the
    expert dimension of the per-expert MLP weights. Embeddings and norms
    replicate. (The sharded encode splits wqkv's columns per projection, so
    that a tp shard holds whole heads of q, k and v.)"""
    layers: Dict[str, Tuple] = {
        "ln1_scale": (None, None),
        "ln1_bias": (None, None),
        "wqkv": (None, None, "tp"),
        "wo": (None, "tp", None),
        "ln2_scale": (None, None),
        "ln2_bias": (None, None),
    }
    if cfg.attn_bias:
        layers["b_qkv"] = (None, "tp")
        layers["b_o"] = (None, None)
    if cfg.n_experts > 0:
        layers.update({
            "gate": (None, None, None),
            "w_up_e": (None, "ep", None, "tp"),
            "b_up_e": (None, "ep", "tp"),
            "w_down_e": (None, "ep", "tp", None),
            "b_down_e": (None, "ep", None),
        })
    else:
        layers.update({
            "w_up": (None, None, "tp"),
            "b_up": (None, "tp"),
            "w_down": (None, "tp", None),
            "b_down": (None, None),
        })
    specs: Dict[str, Tuple] = {
        "tok_emb": (None, None),
        "pos_emb": (None, None),
        "ln_in_scale": (None,),
        "ln_in_bias": (None,),
        "ln_out_scale": (None,),
        "ln_out_bias": (None,),
    }
    specs.update({LAYER_PREFIX + k: v for k, v in layers.items()})
    return specs


def _tc_mm(a: torch.Tensor, b: torch.Tensor, acc=None) -> torch.Tensor:
    """The tensor-core product of two CUDA operands of one 16-bit dtype,
    summed in f32 with an f32 result: [M, K] @ [K, N], or batched; added
    to the f32 `acc` when given (in the product's epilogue)."""
    if acc is None:
        if a.dim() == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32)
    if a.dim() == 2:
        return torch.addmm(acc, a, b, out_dtype=torch.float32)
    return torch.baddbmm(acc, a, b, out_dtype=torch.float32)


def pieces_mm(pieces, w: torch.Tensor, pieces_left: bool = True, mm=_tc_mm) -> torch.Tensor:
    """f @ w (or w @ f, pieces_left False) for an f32 f given as its
    `split_bf16` pieces and a bf16 w: the f32 product of f with w's values
    summed in f32, as three tensor-core products, the smallest piece first,
    each added to the last in f32 (a piece times a bf16 value is exact in
    f32)."""
    out = None
    for piece in reversed(pieces):
        out = mm(piece, w, out) if pieces_left else mm(w, piece, out)
    return out


class _TensorCoreMM(torch.autograd.Function):
    """`_tc_mm` with the JAX transpose rule of a bf16 x bf16 -> f32
    product (`_dot_general_transpose_lhs`): each operand's gradient is the
    f32 cotangent times the other bf16 operand, summed in f32, rounded to
    the operand's dtype (the `w.to(x.dtype)` cast then carries a weight's
    gradient to its f32 master copy). PyTorch registers no backward for
    the `out_dtype` products; the f32 cotangent goes to the tensor cores
    in three bf16 pieces (`split_bf16`), not as one f32 product, which the
    card runs on its f32 cores at a fifteenth of the bf16 rate."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tc_mm(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        pieces = split_bf16(g)  # once for both gradients
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = pieces_mm(pieces, b.transpose(-2, -1)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = pieces_mm(pieces, a.transpose(-2, -1), pieces_left=False).to(b.dtype)
        return ga, gb


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b summed in f32, for operands of one dtype: [M, K] @ [K, N], or
    [G, M, K] @ [G, K, N] batched.

    Route: a bf16 (or f16) product on a CUDA device goes to the tensor
    cores with f32 accumulation and an f32 result (`out_dtype`), which is
    the JAX einsum's `preferred_element_type=f32`: the logits are not
    rounded before the softmax, nor the MLP's up-projection before its
    bias; a bf16 product that needs a gradient goes through
    `_TensorCoreMM` (an f16 one has no backward and raises there).
    Elsewhere the bf16-valued operands are multiplied in f32 (the
    products of two bf16 numbers are exact in f32, so this is the same
    function, and autograd differentiates it). f32 operands take the plain
    f32 product; the process's TF32 flag is left as it is (off, so that
    the f32 index tiers stay exact)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        if a.dtype == torch.bfloat16 and torch.is_grad_enabled() and (
                a.requires_grad or b.requires_grad):
            return _TensorCoreMM.apply(a, b)
        return _tc_mm(a, b)
    return torch.matmul(a.float(), b.float())


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, L, K] @ [K, N] -> [B, L, N] f32 (weights cast to x's dtype at use)."""
    B, L, K = x.shape
    return _mm(x.reshape(B * L, K), w.to(x.dtype)).reshape(B, L, -1)


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def _attention(x, wqkv, wo, attn_bias, cfg: EncoderConfig, b_qkv=None, b_o=None):
    """Bidirectional multi-head attention. x: [B, L, H]."""
    B, L, H = x.shape
    nh, hd = cfg.n_heads, cfg.head_dim
    qkv = _dense(x, wqkv)
    if b_qkv is not None:
        qkv = qkv + b_qkv
    qkv = qkv.to(x.dtype).reshape(B, L, 3, nh, hd).permute(2, 0, 3, 1, 4)
    q, k, v = (t.reshape(B * nh, L, hd) for t in qkv)  # [B*nh, L, hd]
    logits = _mm(q, k.transpose(1, 2)).reshape(B, nh, L, L)
    logits = logits / math.sqrt(hd) + attn_bias  # f32, [B, nh, L, L]
    probs = torch.softmax(logits, dim=-1).to(x.dtype).reshape(B * nh, L, L)
    ctx = _mm(probs, v).to(x.dtype)
    ctx = ctx.reshape(B, nh, L, hd).transpose(1, 2).reshape(B, L, H)
    out = _dense(ctx, wo)
    if b_o is not None:
        out = out + b_o
    return out.to(x.dtype)


def _mlp(x, w_up, b_up, w_down, b_down, approx: bool = True):
    h = _dense(x, w_up)
    h = F.gelu(h + b_up, approximate="tanh" if approx else "none").to(x.dtype)
    return (_dense(h, w_down) + b_down).to(x.dtype)


def _moe_mlp(x, gate, w_up_e, b_up_e, w_down_e, b_down_e):
    """Dense-dispatch mixture of experts: every expert computes every
    token and the gate-weighted sum reduces over the expert axis (JAX's
    `_moe_mlp`, whose GELU is the tanh form whatever `cfg.act` says)."""
    dt = x.dtype
    probs = torch.softmax(torch.einsum("blh,he->ble", x.float(), gate.float()),
                          dim=-1).to(dt)
    h = torch.einsum("blh,ehf->belf", x.float(), w_up_e.to(dt).float())
    h = F.gelu(h + b_up_e[None, :, None, :], approximate="tanh").to(dt)
    y = torch.einsum("belf,efh->belh", h.float(), w_down_e.to(dt).float())
    y = y + b_down_e[None, :, None, :]
    return torch.einsum("ble,belh->blh", probs.float(), y).to(dt)


def route_rows(x: torch.Tensor, gate: torch.Tensor, top_k: int, capacity_factor: float):
    """The routing of the routed MoE, a group per batch row of x [B, L, H]:
    each row sends its L tokens' top-k experts (a tie to the lower expert,
    as `lax.top_k`) into per-expert buffers of C = ceil(capacity_factor * k
    * L / E) slots, in arrival order over (L, k); tokens past capacity drop.
    Returns (combine [B, L, E, C] f32: each kept slot's gate weight, 0
    elsewhere; C)."""
    from codegraph_tpu_torch.parallel.moe import _dispatch_indices, topk_experts

    L = x.shape[1]
    E = gate.shape[-1]
    scores = torch.einsum("blh,he->ble", x.float(), gate.float())
    top_s, top_e = topk_experts(scores, top_k)                   # [B, L, k]
    w = torch.softmax(top_s, dim=-1)
    C = max(1, math.ceil(capacity_factor * top_k * L / E))
    oe = F.one_hot(top_e, E)                                     # [B, L, k, E]
    pos, keep = _dispatch_indices(top_e, top_k, E, C)            # per row
    oc = F.one_hot(torch.where(keep, pos, 0), C).float()         # [B, L, k, C]
    wk = torch.where(keep, w, 0.0)
    combine = torch.einsum("blke,blkc,blk->blec", oe.float(), oc, wk)
    return combine, C


def dispatch_rows(x: torch.Tensor, combine: torch.Tensor) -> torch.Tensor:
    """The experts' buffers [E, B*C, H] in x's dtype: slot (e, b, c) holds
    the token routed there, zeros where none is (a dropped slot's weight is
    exactly 0, and a softmax weight never is)."""
    B, L, E, C = combine.shape
    buf = torch.einsum("blec,blh->bech", (combine > 0).float(), x.float())
    return buf.transpose(0, 1).reshape(E, B * C, -1).to(x.dtype)


def routed_experts(buf, w_up_e, b_up_e, w_down_e) -> torch.Tensor:
    """[E, N, H] buffers through their experts' MLP up to w_down (f32; the
    caller adds b_down_e): products in the buffers' dtype summed in f32,
    tanh GELU."""
    dt = buf.dtype
    h = _mm(buf, w_up_e.to(dt))
    h = F.gelu(h + b_up_e[:, None, :], approximate="tanh").to(dt)
    return _mm(h, w_down_e.to(dt))


def combine_rows(y: torch.Tensor, combine: torch.Tensor, dtype) -> torch.Tensor:
    """y [E, B*C, H] (f32) back to token order, each token's slots weighted."""
    B, L, E, C = combine.shape
    y = y.reshape(E, B, C, -1).transpose(0, 1)                     # [B, E, C, H]
    return torch.einsum("blec,bech->blh", combine, y).to(dtype)


def _moe_mlp_routed(x, gate, w_up_e, b_up_e, w_down_e, b_down_e, top_k: int,
                    capacity_factor: float):
    """GShard-style top-k routed MoE (JAX's `_moe_mlp_routed`): a group per
    batch row routes into per-expert buffers; dispatch and combine are
    one-hot einsums, as in the reference."""
    combine, _ = route_rows(x, gate, top_k, capacity_factor)
    buf = dispatch_rows(x, combine)
    y = routed_experts(buf, w_up_e, b_up_e, w_down_e) + b_down_e[:, None, :]
    return combine_rows(y, combine, x.dtype)


def pool(x: torch.Tensor, mask: torch.Tensor, params: Params, cfg: EncoderConfig,
         normalize: bool) -> torch.Tensor:
    """The layers' output [B, L, H] -> [B, H] f32: the final norm (pre-LN
    only), cfg.pooling, then L2 normalisation unless `normalize` is False."""
    if cfg.norm_style != "post":
        # the final norm belongs to the pre-LN architecture only: BERT-family
        # (post) models end with each layer's own LayerNorm
        x = _layer_norm(x, params["ln_out_scale"], params["ln_out_bias"], cfg.eps)
    xf = x.float()
    mf = mask.float()[:, :, None]
    if cfg.pooling == "cls":
        pooled = xf[:, 0, :]
    elif cfg.pooling == "max":
        pooled = torch.where(mf > 0, xf, -1e30).amax(dim=1)
    else:  # mean
        pooled = (xf * mf).sum(dim=1) / mf.sum(dim=1).clamp(min=1.0)
    if normalize:
        sq = pooled.square().sum(dim=-1, keepdim=True)
        pooled = pooled * torch.rsqrt(sq.clamp(min=1e-12))
    return pooled


def encode(params: Params, token_ids: torch.Tensor, mask: torch.Tensor,
           cfg: EncoderConfig, normalize: bool = True, mesh=None,
           dp_axis: Optional[str] = None, sp_axis: Optional[str] = None,
           ep_axis: Optional[str] = None) -> torch.Tensor:
    """Forward pass: [B, L] int tokens + [B, L] bool mask -> [B, H] f32,
    pooled per cfg.pooling (masked mean by default), then L2-normalized
    unless `normalize` is False. Differentiable in the parameters; with
    cfg.remat and autograd recording, each layer's activations are
    recomputed in the backward pass instead of kept.

    With a `mesh` (`parallel/mesh.py`) the forward runs across its devices
    (`parallel/sharded_encode.py`): the batch over `dp_axis`, the sequence
    over `sp_axis` between attention blocks (attention gathers k/v), heads
    and MLP columns over the mesh's "tp" axis, experts over `ep_axis`; the
    result lives on the mesh's first device. Without a mesh the axis names
    mean nothing."""
    if mesh is not None:
        from codegraph_tpu_torch.parallel.sharded_encode import encode_on_mesh

        return encode_on_mesh(params, token_ids, mask, cfg, normalize, mesh,
                              dp_axis=dp_axis, sp_axis=sp_axis, ep_axis=ep_axis)
    B, L = token_ids.shape
    dt = cfg.dtype
    x = (F.embedding(token_ids.long(), params["tok_emb"]) + params["pos_emb"][:L][None]).to(dt)
    x = _layer_norm(x, params["ln_in_scale"], params["ln_in_bias"], cfg.eps)

    attn_bias = torch.where(mask[:, None, None, :], 0.0, -1e30).float()
    approx = cfg.act != "gelu_exact"

    def ffn(h, lp):
        if cfg.n_experts > 0 and cfg.moe_top_k > 0:
            return _moe_mlp_routed(h, lp["gate"], lp["w_up_e"], lp["b_up_e"], lp["w_down_e"],
                                   lp["b_down_e"], cfg.moe_top_k, cfg.moe_capacity)
        if cfg.n_experts > 0:
            return _moe_mlp(h, lp["gate"], lp["w_up_e"], lp["b_up_e"],
                            lp["w_down_e"], lp["b_down_e"])
        return _mlp(h, lp["w_up"], lp["b_up"], lp["w_down"], lp["b_down"],
                    approx=approx)

    def layer(x, lp):
        b_qkv, b_o = lp.get("b_qkv"), lp.get("b_o")
        if cfg.norm_style == "post":
            # BERT-family residual order: LN AFTER each residual add
            x = x + _attention(x, lp["wqkv"], lp["wo"], attn_bias, cfg,
                               b_qkv=b_qkv, b_o=b_o)
            x = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], cfg.eps)
            return _layer_norm(x + ffn(x, lp), lp["ln2_scale"], lp["ln2_bias"], cfg.eps)
        h = _layer_norm(x, lp["ln1_scale"], lp["ln1_bias"], cfg.eps)
        x = x + _attention(h, lp["wqkv"], lp["wo"], attn_bias, cfg, b_qkv=b_qkv, b_o=b_o)
        h = _layer_norm(x, lp["ln2_scale"], lp["ln2_bias"], cfg.eps)
        return x + ffn(h, lp)

    remat = cfg.remat and torch.is_grad_enabled()
    names = [k[len(LAYER_PREFIX):] for k in params if k.startswith(LAYER_PREFIX)]
    for i in range(cfg.n_layers):
        lp = {n: params[LAYER_PREFIX + n][i] for n in names}
        if remat:
            x = torch.utils.checkpoint.checkpoint(layer, x, lp, use_reentrant=False)
        else:
            x = layer(x, lp)
    return pool(x, mask, params, cfg, normalize)


__all__ = [
    "EncoderConfig",
    "init_encoder_params",
    "encoder_param_shardings",
    "encoder_params_from_jax",
    "encoder_params_to_jax",
    "encode",
    "split_bf16",
    "pieces_mm",
]

"""The encoder's forward across a device mesh: `models/encoder.py`
`encode(..., mesh=..., dp_axis=..., sp_axis=..., ep_axis=...)`.

The JAX package expresses this with sharding constraints inside `encode`
(`codegraph_tpu/models/encoder.py` `encode`, `cstr`) and leaves the
collectives to XLA; here they are written out over the mesh's devices:

* dp: the batch splits into contiguous row ranges, one per dp coordinate;
* sp: between attention blocks the sequence splits too (the token-parallel
  regions: embeddings, norms, MLP); attention gathers each head's k and v
  over the sp shards and each shard attends with its own queries;
* tp (the mesh's "tp" axis, as `encoder_param_shardings` names it): each tp
  shard holds whole heads of q, k and v (wqkv's columns split per
  projection), a row block of wo, a column block of w_up/b_up (and of each
  expert's) and a row block of w_down; the row-parallel products' parts are
  summed (psum) and their bias added once after;
* ep: the experts split over ep. The dense MoE's experts each compute
  every token and their gate-weighted parts are summed; the routed MoE
  routes each batch row over its whole sequence (gathered over sp), sends
  each expert's buffer slots to the expert's shard and back.

A token shard of dp coordinate i and sp coordinate j lives on the device at
(dp=i, sp=j) with the other axes at 0; its tp/ep parts run on the devices
at (dp=i, sp=j, tp=t, ep=e). The parameters stay where the caller keeps
them (e.g. one master copy for training); each forward takes its shards as
views on that device or copies on another, and the gradients of the shards
flow back to them. The layer outputs gather on the mesh's first device for
the final norm and pooling (`models/encoder.py` `pool`). With cfg.remat
each layer's activations of a dp shard are recomputed in the backward
pass. On any mesh the result is `encode`'s without one, to f32 rounding.

The layer (`_layer`, on a `_Layout` of devices) is also the stage layer of
`parallel/pipeline.py` `pp_encode`, on a layout of one stage's devices.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from codegraph_tpu_torch.models.encoder import (
    LAYER_PREFIX,
    EncoderConfig,
    Params,
    _dense,
    _layer_norm,
    _mm,
    combine_rows,
    dispatch_rows,
    pool,
    route_rows,
    routed_experts,
)
from codegraph_tpu_torch.parallel.mesh import Mesh, psum

TP_AXIS = "tp"


class _Layout:
    """Which devices hold what: the token shards (dp x sp) and, for each,
    its tp x ep part devices. `at` fixes the coordinates of axes the
    layout does not use (a pipeline stage's pp coordinate); other unused
    axes are at 0."""

    def __init__(self, mesh: Mesh, cfg: EncoderConfig, dp_axis=None, sp_axis=None,
                 ep_axis=None, tp_axis=None, at: Optional[Dict[str, int]] = None):
        for name in (dp_axis, sp_axis, ep_axis, tp_axis):
            if name is not None and name not in mesh.axis_names:
                raise ValueError(f"no mesh axis {name!r} in {mesh.axis_names}")
        self.mesh = mesh
        self.at = dict(at or {})
        self.dp_axis, self.sp_axis, self.tp_axis = dp_axis, sp_axis, tp_axis
        self.ep_axis = ep_axis if cfg.n_experts > 0 else None
        size = lambda a: mesh.shape[a] if a else 1  # noqa: E731
        self.dp, self.sp, self.tp, self.ep = (size(self.dp_axis), size(self.sp_axis),
                                              size(self.tp_axis), size(self.ep_axis))
        Fh = cfg.mlp_hidden
        if cfg.n_heads % self.tp or Fh % self.tp:
            raise ValueError(f"n_heads={cfg.n_heads} and mlp_hidden={Fh} must divide by "
                             f"tp={self.tp}")
        if cfg.n_experts and cfg.n_experts % self.ep:
            raise ValueError(f"n_experts={cfg.n_experts} must divide by ep={self.ep}")

    def device(self, i=0, j=0, t=0, e=0) -> torch.device:
        c = dict(self.at)
        for axis, v in ((self.dp_axis, i), (self.sp_axis, j), (self.tp_axis, t),
                        (self.ep_axis, e)):
            if axis is not None:
                c[axis] = v
        return self.mesh.device(**c)


def _on(cache: Dict, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """t on dev, moved once per forward (keyed by the tensor's identity; the
    cache holds t, so that its id is not reused while the entry lives)."""
    key = (id(t), dev)
    if key not in cache:
        cache[key] = (t, t.to(dev))
    return cache[key][1]


# -- Megatron blocks (JAX's `parallel/pipeline.py` `_attention_tp`/`_mlp_tp`) --

def split_qkv(wqkv: torch.Tensor, cfg: EncoderConfig):
    """The fused [..., H, 3H] wqkv (or [..., 3H] b_qkv) as its (q, k, v)
    parts, each [..., H, H] with (n_heads, head_dim) column order."""
    H = cfg.hidden
    w3 = wqkv.reshape(*wqkv.shape[:-1], 3, H)
    return w3[..., 0, :], w3[..., 1, :], w3[..., 2, :]


def tp_blocks(lp: Dict[str, torch.Tensor], cfg: EncoderConfig, tp: int) -> List[Dict[str, torch.Tensor]]:
    """One layer's Megatron blocks, a dict per tp shard (views of the
    parameters): wq/wk/wv (and bq/bk/bv) column blocks, so that a shard
    holds n_heads / tp whole heads of each, w_up and b_up column blocks,
    wo and w_down row blocks; the MLP's only for a dense MLP."""
    def cols(w):
        return torch.chunk(w, tp, dim=-1)

    def rows(w):
        return torch.chunk(w, tp, dim=-2)

    wq, wk, wv = split_qkv(lp["wqkv"], cfg)
    parts = {"wq": cols(wq), "wk": cols(wk), "wv": cols(wv), "wo": rows(lp["wo"])}
    if "b_qkv" in lp:
        bq, bk, bv = split_qkv(lp["b_qkv"], cfg)
        parts.update({"bq": cols(bq), "bk": cols(bk), "bv": cols(bv)})
    if "w_up" in lp:
        parts.update({"w_up": cols(lp["w_up"]), "b_up": cols(lp["b_up"]),
                      "w_down": rows(lp["w_down"])})
    return [{n: p[t] for n, p in parts.items()} for t in range(tp)]


def qkv_heads(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: EncoderConfig):
    """One tp shard's heads of x [B, L, H]: (q, k, v), each [B, L, n_heads
    / tp, head_dim] in x's dtype, from the shard's column blocks p."""
    B, L, _ = x.shape
    out = []
    for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        y = _dense(x, p[w])
        if b in p:
            y = y + p[b]
        out.append(y.to(x.dtype).reshape(B, L, -1, cfg.head_dim))
    return out


def heads_attention(q, k, v, wo, attn_bias, dtype) -> torch.Tensor:
    """Attention of q [B, Lq, n, hd] against k, v [B, Lk, n, hd] (values of
    `dtype`; attn_bias [B, 1, 1, Lk] f32), then those heads' rows of wo: one
    tp shard's f32 part [B, Lq, H] of the output (the row-parallel product,
    summed over tp by the caller)."""
    B, Lq, n, hd = q.shape
    Lk = k.shape[1]
    qh = q.transpose(1, 2).reshape(B * n, Lq, hd)
    kh = k.transpose(1, 2).reshape(B * n, Lk, hd)
    vh = v.transpose(1, 2).reshape(B * n, Lk, hd)
    logits = _mm(qh, kh.transpose(1, 2)).reshape(B, n, Lq, Lk)
    logits = logits / math.sqrt(hd) + attn_bias
    probs = torch.softmax(logits, dim=-1).to(dtype).reshape(B * n, Lq, Lk)
    ctx = _mm(probs, vh).to(dtype)
    ctx = ctx.reshape(B, n, Lq, hd).transpose(1, 2).reshape(B, Lq, n * hd)
    return _dense(ctx, wo)


def mlp_tp(x, w_up, b_up, w_down, approx: bool = True) -> torch.Tensor:
    """One tp shard's Megatron MLP: column-sharded w_up with its GELU,
    row-sharded w_down. Returns the shard's f32 part; the caller sums over
    tp, adds b_down once and casts to x's dtype."""
    h = F.gelu(_dense(x, w_up) + b_up, approximate="tanh" if approx else "none").to(x.dtype)
    return _dense(h, w_down)


# -- one layer over the mesh ---------------------------------------------------

def _layer_parts(lp: Dict[str, torch.Tensor], cfg: EncoderConfig, lay: _Layout):
    """One layer's tp blocks (`tp_blocks`) and, for a mixture of experts, its
    expert blocks: {(e, t): {name: block}} and {e: b_down_e block}; views on
    the parameters' own device."""
    tp_parts = tp_blocks(lp, cfg, lay.tp)
    if cfg.n_experts == 0:
        return tp_parts, None
    cols = lambda w: torch.chunk(w, lay.tp, dim=-1)  # noqa: E731
    rows = lambda w: torch.chunk(w, lay.tp, dim=-2)  # noqa: E731
    experts = {}
    for e, (w_up, b_up, w_down, b_down) in enumerate(zip(*(torch.chunk(lp[n], lay.ep) for n in (
            "w_up_e", "b_up_e", "w_down_e", "b_down_e")))):
        for t in range(lay.tp):
            experts[e, t] = {"w_up_e": cols(w_up)[t], "b_up_e": cols(b_up)[t],
                             "w_down_e": rows(w_down)[t]}
        experts[e] = b_down
    return tp_parts, experts


def _attention(hs, ab, parts, lp, cfg: EncoderConfig, lay: _Layout, cache, i: int):
    """Multi-head attention of dp shard i's token shards hs (list over sp):
    each tp shard projects its heads on every sp shard (`qkv_heads`),
    gathers k and v over sp, attends with each shard's queries
    (`heads_attention`); the parts sum over tp. Returns each sp shard's
    output in its dtype (with b_o)."""
    dt = hs[0].dtype
    outs: List[List[torch.Tensor]] = [[] for _ in hs]
    for t, p in enumerate(parts):
        devs = [lay.device(i, j, t) for j in range(len(hs))]
        heads = [qkv_heads(h.to(d), {n: _on(cache, w, d) for n, w in p.items()}, cfg)
                 for h, d in zip(hs, devs)]
        for j, dev in enumerate(devs):
            # gather this tp shard's k and v over the sp shards: the full sequence
            kf = torch.cat([kv[1].to(dev) for kv in heads], dim=1)
            vf = torch.cat([kv[2].to(dev) for kv in heads], dim=1)
            outs[j].append(heads_attention(heads[j][0], kf, vf, _on(cache, p["wo"], dev),
                                           ab[j].to(dev), dt))
    result = []
    for j, h in enumerate(hs):
        out = psum([o.to(h.device) for o in outs[j]])[0]
        if "b_o" in lp:
            out = out + _on(cache, lp["b_o"], h.device)
        result.append(out.to(dt))
    return result


def _mlp(hs, parts, lp, cfg: EncoderConfig, lay: _Layout, cache, i: int):
    """The dense MLP of each token shard: column blocks of w_up with their
    GELU, row blocks of w_down; the parts sum over tp, b_down after."""
    result = []
    for j, h in enumerate(hs):
        pieces = []
        for t, p in enumerate(parts):
            dev = lay.device(i, j, t)
            pieces.append(mlp_tp(h.to(dev), *(_on(cache, p[n], dev) for n in ("w_up", "b_up",
                                                                                 "w_down")),
                                 approx=cfg.act != "gelu_exact"))
        out = psum([o.to(h.device) for o in pieces])[0] + _on(cache, lp["b_down"], h.device)
        result.append(out.to(h.dtype))
    return result


def _moe_dense(hs, experts, lp, lay: _Layout, cache, i: int):
    """The dense-dispatch MoE of each token shard (JAX's `_moe_mlp`): every
    expert block (e, t) computes every token; the gate-weighted parts sum
    over ep and tp."""
    result = []
    for j, h in enumerate(hs):
        dt = h.dtype
        gate = _on(cache, lp["gate"], h.device)
        probs = torch.softmax(torch.einsum("blh,he->ble", h.float(), gate.float()), dim=-1).to(dt)
        pr = torch.chunk(probs, lay.ep, dim=-1)
        parts = []
        for e in range(lay.ep):
            ys = []
            for t in range(lay.tp):
                dev = lay.device(i, j, t, e)
                p = {n: _on(cache, w, dev) for n, w in experts[e, t].items()}
                hh = torch.einsum("blh,ehf->belf", h.to(dev).float(), p["w_up_e"].to(dt).float())
                hh = F.gelu(hh + p["b_up_e"][None, :, None, :], approximate="tanh").to(dt)
                ys.append(torch.einsum("belf,efh->belh", hh.float(),
                                       p["w_down_e"].to(dt).float()))
            dev = lay.device(i, j, 0, e)
            y = psum([o.to(dev) for o in ys])[0] + _on(cache, experts[e], dev)[None, :, None, :]
            parts.append(torch.einsum("ble,belh->blh", pr[e].to(dev).float(), y))
        result.append(psum([o.to(h.device) for o in parts])[0].to(dt))
    return result


def _moe_routed(hs, experts, lp, cfg: EncoderConfig, lay: _Layout, cache, i: int):
    """The routed MoE of dp shard i (JAX's `_moe_mlp_routed` under ep): the
    rows gather over sp (a row is one routing group), the buffers [E, B*C,
    H] split by expert over ep (each block also over tp), the experts' f32
    outputs come back and combine in token order, then split over sp."""
    home = hs[0].device
    x = torch.cat([h.to(home) for h in hs], dim=1)                # [B_i, L, H]
    combine, _ = route_rows(x, _on(cache, lp["gate"], home), cfg.moe_top_k, cfg.moe_capacity)
    bufs = torch.chunk(dispatch_rows(x, combine), lay.ep)        # per ep shard
    ys = []
    for e, buf in enumerate(bufs):
        parts = []
        for t in range(lay.tp):
            dev = lay.device(i, 0, t, e)
            p = {n: _on(cache, w, dev) for n, w in experts[e, t].items()}
            parts.append(routed_experts(buf.to(dev), p["w_up_e"], p["b_up_e"], p["w_down_e"]))
        dev = lay.device(i, 0, 0, e)
        y = psum([o.to(dev) for o in parts])[0] + _on(cache, experts[e], dev)[:, None, :]
        ys.append(y.to(home))
    out = combine_rows(torch.cat(ys), combine, x.dtype)
    sizes = [h.shape[1] for h in hs]
    return [o.to(h.device) for o, h in zip(torch.split(out, sizes, dim=1), hs)]


def _norm(hs, scale, bias, cfg: EncoderConfig, cache):
    return [_layer_norm(h, _on(cache, scale, h.device), _on(cache, bias, h.device), cfg.eps)
            for h in hs]


def _ffn(hs, lp, parts, experts, cfg: EncoderConfig, lay: _Layout, cache, i: int):
    if cfg.n_experts > 0 and cfg.moe_top_k > 0:
        return _moe_routed(hs, experts, lp, cfg, lay, cache, i)
    if cfg.n_experts > 0:
        return _moe_dense(hs, experts, lp, lay, cache, i)
    return _mlp(hs, parts, lp, cfg, lay, cache, i)


def _layer(xs, ab, lp, parts, experts, cfg: EncoderConfig, lay: _Layout, cache, i: int):
    """One layer over dp shard i's token shards xs (ab: their attention
    biases); every input is an argument, so that a recomputation (remat)
    sees this shard's."""
    if cfg.norm_style == "post":
        a = _attention(xs, ab, parts, lp, cfg, lay, cache, i)
        xs = _norm([x + y for x, y in zip(xs, a)], lp["ln1_scale"], lp["ln1_bias"], cfg, cache)
        y = _ffn(xs, lp, parts, experts, cfg, lay, cache, i)
        return _norm([x + f for x, f in zip(xs, y)], lp["ln2_scale"], lp["ln2_bias"], cfg, cache)
    a = _attention(_norm(xs, lp["ln1_scale"], lp["ln1_bias"], cfg, cache), ab, parts, lp, cfg,
                   lay, cache, i)
    xs = [x + y for x, y in zip(xs, a)]
    y = _ffn(_norm(xs, lp["ln2_scale"], lp["ln2_bias"], cfg, cache), lp, parts, experts, cfg, lay,
             cache, i)
    return [x + f for x, f in zip(xs, y)]


def encode_on_mesh(params: Params, token_ids: torch.Tensor, mask: torch.Tensor,
                   cfg: EncoderConfig, normalize: bool, mesh: Mesh,
                   dp_axis: Optional[str] = None, sp_axis: Optional[str] = None,
                   ep_axis: Optional[str] = None) -> torch.Tensor:
    """`encode` across `mesh` (see the module docstring). Returns [B, H]
    f32 on the mesh's first device."""
    lay = _Layout(mesh, cfg, dp_axis, sp_axis, ep_axis,
                  tp_axis=TP_AXIS if TP_AXIS in mesh.axis_names else None)
    remat = cfg.remat and torch.is_grad_enabled()
    dt = cfg.dtype
    B, L = token_ids.shape
    cache: Dict = {}
    names = [n[len(LAYER_PREFIX):] for n in params if n.startswith(LAYER_PREFIX)]
    layer_parts = []
    for layer in range(cfg.n_layers):
        lp = {n: params[LAYER_PREFIX + n][layer] for n in names}
        layer_parts.append((lp, *_layer_parts(lp, cfg, lay)))

    row_ranges = torch.tensor_split(torch.arange(B), lay.dp)
    col_ranges = torch.tensor_split(torch.arange(L), lay.sp)
    outs = []
    for i, rows in enumerate(row_ranges):
        r0, r1 = int(rows[0]), int(rows[-1]) + 1
        xs, ab = [], []
        m_full = mask[r0:r1]
        for j, cols in enumerate(col_ranges):
            c0, c1 = int(cols[0]), int(cols[-1]) + 1
            dev = lay.device(i, j)
            ids = token_ids[r0:r1, c0:c1].to(dev).long()
            x = (F.embedding(ids, _on(cache, params["tok_emb"], dev))
                 + _on(cache, params["pos_emb"], dev)[c0:c1][None]).to(dt)
            xs.append(_layer_norm(x, _on(cache, params["ln_in_scale"], dev),
                                  _on(cache, params["ln_in_bias"], dev), cfg.eps))
            ab.append(torch.where(m_full.to(dev)[:, None, None, :], 0.0, -1e30).float())

        for lp, parts, experts in layer_parts:
            args = (xs, ab, lp, parts, experts, cfg, lay, cache, i)
            if remat:
                xs = torch.utils.checkpoint.checkpoint(_layer, *args, use_reentrant=False)
            else:
                xs = _layer(*args)
        outs.append(torch.cat([x.to(mesh.first_device) for x in xs], dim=1))
    x = torch.cat(outs)
    first = {k: params[k].to(mesh.first_device) for k in ("ln_out_scale", "ln_out_bias")}
    return pool(x, mask.to(mesh.first_device), first, cfg, normalize)


__all__ = ["encode_on_mesh"]

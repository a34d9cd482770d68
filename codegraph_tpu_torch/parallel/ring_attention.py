"""Port of `codegraph_tpu/parallel/ring_attention.py`: ring attention, true
sequence parallelism for long contexts.

Each sequence shard keeps its queries while the key/value blocks (and their
mask) rotate around the sp ring (`ppermute`), and a streaming
(online-softmax) accumulator merges each visiting block: the running (max,
denominator, output) recurrence of flash attention, across devices. Peak
activation memory per shard is O(L / sp).

Numerics: logits and the (m, l, o) accumulators are f32; masked keys carry a
-1e30 bias. Blocks seen before any valid key are wiped by the correction
factor exp(m_old - m_new) = 0 once a real key raises m, so the streaming
merge is exact (dense softmax to f32 rounding). Gradients flow through the
ring, so `sp_ring_encode` trains end to end.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch

from codegraph_tpu_torch.models.encoder import (
    LAYER_PREFIX,
    EncoderConfig,
    Params,
    _dense,
    _layer_norm,
    _mlp,
)
from codegraph_tpu_torch.parallel.mesh import Mesh, ppermute, psum

_NEG = -1e30


def ring_attention(
    q: Sequence[torch.Tensor],        # per shard [B, Ll, nh, hd]: the shard's queries
    k: Sequence[torch.Tensor],        # per shard [B, Ll, nh, hd]: the shard's keys
    v: Sequence[torch.Tensor],        # per shard [B, Ll, nh, hd]: the shard's values
    kv_mask: Sequence[torch.Tensor],  # per shard [B, Ll] bool: valid keys
) -> List[torch.Tensor]:
    """Bidirectional ring attention over the shards of one sequence-parallel
    ring: returns each shard's [B, Ll, nh, hd] f32, the exact softmax(QK^T)V
    of its queries against the whole sequence, in n_shards ring steps."""
    n = len(q)
    perm = [(d, (d + 1) % n) for d in range(n)]
    qf, m, l, o = [], [], [], []
    for qd in q:
        B, Ll, nh, hd = qd.shape
        qf.append(qd.float() / math.sqrt(hd))
        m.append(torch.full((B, nh, Ll), _NEG, dtype=torch.float32, device=qd.device))
        l.append(torch.zeros((B, nh, Ll), dtype=torch.float32, device=qd.device))
        o.append(torch.zeros((B, Ll, nh, hd), dtype=torch.float32, device=qd.device))
    k, v, kv_mask = list(k), list(v), list(kv_mask)
    for _ in range(n):
        for d in range(n):
            logits = torch.einsum("bqnd,bknd->bnqk", qf[d], k[d].float())
            logits = logits + torch.where(kv_mask[d][:, None, None, :], 0.0, _NEG)
            m_new = torch.maximum(m[d], logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])              # [B, nh, Lq, Lk]
            corr = torch.exp(m[d] - m_new)                          # [B, nh, Lq]
            l[d] = l[d] * corr + p.sum(dim=-1)
            o[d] = o[d] * corr.transpose(1, 2)[..., None] + torch.einsum(
                "bnqk,bknd->bqnd", p, v[d].float())
            m[d] = m_new
        # rotate the K/V blocks (and their masks) to the next shard
        k, v, kv_mask = ppermute(k, perm), ppermute(v, perm), ppermute(kv_mask, perm)
    return [od / torch.clamp(ld.transpose(1, 2)[..., None], min=1e-30) for od, ld in zip(o, l)]


def _replicate(params: Params, devices) -> dict:
    """The parameters on each distinct device of `devices` (no copy where
    they already lie)."""
    return {d: {k: t.to(d) for k, t in params.items()} for d in set(devices)}


def sp_ring_encode(
    params: Params,
    token_ids: torch.Tensor,   # [B, L] with L % sp == 0
    mask: torch.Tensor,        # [B, L] bool
    cfg: EncoderConfig,
    mesh: Mesh,
    sp_axis: str = "sp",
    dp_axis: Optional[str] = None,
    normalize: bool = True,
) -> torch.Tensor:
    """Encoder forward with ring attention: activations stay sequence-sharded
    through every op (embeddings, norms, attention, MLP, pooling), O(L/sp)
    activation memory per shard. The batch splits over dp_axis. Equals
    models/encoder.py `encode` to f32 rounding; returns [B, H] f32 on the
    mesh's first device."""
    if cfg.n_experts > 0:
        raise NotImplementedError("ring-sp MoE: compose sp with ep instead")
    if cfg.pooling != "mean":
        raise NotImplementedError("ring-sp pooling: mean only")
    sp = mesh.shape[sp_axis]
    dp = mesh.shape[dp_axis] if dp_axis else 1
    B, L = token_ids.shape
    if L % sp:
        raise ValueError(f"L={L} must divide by sp={sp}")
    if B % dp:
        raise ValueError(f"B={B} must divide by dp={dp}")
    dt = cfg.dtype
    nh, hd, H = cfg.n_heads, cfg.head_dim, cfg.hidden
    Bl, Ll = B // dp, L // sp
    dev = [[mesh.device(**{sp_axis: j, **({dp_axis: i} if dp_axis else {})}) for j in range(sp)]
           for i in range(dp)]
    on = _replicate(params, [d for row in dev for d in row])
    names = [n[len(LAYER_PREFIX):] for n in params if n.startswith(LAYER_PREFIX)]

    pooled = []
    for i in range(dp):
        x, m_l = [], []
        for j in range(sp):
            p, d = on[dev[i][j]], dev[i][j]
            ids = token_ids[i * Bl:(i + 1) * Bl, j * Ll:(j + 1) * Ll].to(d).long()
            m_l.append(mask[i * Bl:(i + 1) * Bl, j * Ll:(j + 1) * Ll].to(d))
            pos = torch.arange(j * Ll, (j + 1) * Ll, device=d)
            xj = (p["tok_emb"][ids] + p["pos_emb"][pos][None]).to(dt)
            x.append(_layer_norm(xj, p["ln_in_scale"], p["ln_in_bias"], cfg.eps))
        for layer in range(cfg.n_layers):
            lps = [{n: on[dev[i][j]][LAYER_PREFIX + n][layer] for n in names} for j in range(sp)]
            qkv = []
            for j in range(sp):
                h = _layer_norm(x[j], lps[j]["ln1_scale"], lps[j]["ln1_bias"], cfg.eps)
                qkv.append(_dense(h, lps[j]["wqkv"]).to(dt).reshape(Bl, Ll, 3, nh, hd))
            ctx = ring_attention([t[:, :, 0] for t in qkv], [t[:, :, 1] for t in qkv],
                                 [t[:, :, 2] for t in qkv], m_l)
            for j in range(sp):
                attn = _dense(ctx[j].to(dt).reshape(Bl, Ll, H), lps[j]["wo"]).to(dt)
                xj = x[j] + attn
                h = _layer_norm(xj, lps[j]["ln2_scale"], lps[j]["ln2_bias"], cfg.eps)
                x[j] = xj + _mlp(h, lps[j]["w_up"], lps[j]["b_up"], lps[j]["w_down"],
                                 lps[j]["b_down"])
        # masked-mean pool: local partial sums, one psum over the ring each
        nums, dens = [], []
        for j in range(sp):
            p = on[dev[i][j]]
            xf = _layer_norm(x[j], p["ln_out_scale"], p["ln_out_bias"], cfg.eps).float()
            mf = m_l[j].float()[:, :, None]
            nums.append((xf * mf).sum(dim=1))
            dens.append(mf.sum(dim=1))
        num, den = psum(nums)[0], psum(dens)[0]
        out = num / torch.clamp(den, min=1.0)
        if normalize:
            sq = out.square().sum(dim=-1, keepdim=True)
            out = out * torch.rsqrt(torch.clamp(sq, min=1e-12))
        pooled.append(out.to(mesh.first_device))
    return torch.cat(pooled)


__all__ = ["ring_attention", "sp_ring_encode"]

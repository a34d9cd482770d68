"""Port of `codegraph_tpu/parallel/pipeline.py`: pipeline-parallel encoder
execution (GPipe over the layer stack), optionally with Megatron tensor
parallelism inside each stage.

Each "pp" stage holds n_layers / pp contiguous layers, the batch splits
into microbatches, and activations flow stage to stage (`ppermute`) in the
GPipe schedule of n_micro + pp - 1 ticks: at tick t stage s runs
microbatch t - s. The JAX package runs every stage at every tick and masks
out the bubble's junk; here a stage runs only in its valid window, which
gives the same result without the bubble's compute. Gradients flow through
the schedule.

A stage runs its layers through the sharded encode's layer
(`parallel/sharded_encode.py`) on a layout of that stage's devices: with a
tp_axis, Megatron-style over it (composite pp x tp: whole heads of q, k, v
and MLP column blocks a tp shard, wo and w_down row blocks, an explicit psum
over tp after each row-parallel product and b_down added once after it);
without one, on the stage's device alone. So each layer is the encoder's
as cfg describes it (norm style, attention biases, a mixture of experts)
and the pooling is `encode`'s: on every cfg the result is `encode`'s. (The
JAX function's stage is a pre-LN dense layer without biases and its pooling
a masked mean, whatever cfg says; on such a cfg the two agree.)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from codegraph_tpu_torch.models.encoder import (
    LAYER_PREFIX,
    EncoderConfig,
    Params,
    _layer_norm,
    encoder_param_shardings,
    pool,
)
from codegraph_tpu_torch.parallel.mesh import Mesh, ppermute
from codegraph_tpu_torch.parallel.sharded_encode import _Layout, _layer, _layer_parts


def pipeline_param_shardings(cfg: EncoderConfig) -> Dict[str, Tuple]:
    """Layer-stacked leaves shard their leading (depth) axis over "pp";
    embeddings and norms replicate. Specs are tuples of axis names (None:
    not sharded), keyed like the parameters; tp names are dropped (the
    composite pp x tp runs through `pp_encode(tp_axis=...)`)."""
    specs = encoder_param_shardings(cfg)
    out = {}
    for name, spec in specs.items():
        if name.startswith(LAYER_PREFIX):
            spec = ("pp",) + tuple(spec[1:])
        out[name] = tuple(a if a == "pp" else None for a in spec)
    return out


def pp_encode(
    params: Params,
    token_ids: torch.Tensor,   # [B, L] with B % n_micro == 0
    mask: torch.Tensor,        # [B, L]
    cfg: EncoderConfig,
    mesh: Mesh,
    n_micro: int,
    pp_axis: str = "pp",
    tp_axis: Optional[str] = None,
    normalize: bool = True,
) -> torch.Tensor:
    """Pipeline-parallel forward: [B, L] -> [B, H] pooled embeddings on the
    mesh's first device.

    cfg.n_layers must divide by the pp mesh size, B by n_micro; with
    tp_axis, n_heads and mlp_hidden by its size, and each stage's layer
    math runs Megatron-style over that axis (composite pp x tp)."""
    pp = mesh.shape[pp_axis]
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} must divide by pipeline stages ({pp})")
    B, L = token_ids.shape
    if B % n_micro:
        raise ValueError(f"B={B} must divide by n_micro={n_micro}")
    Bm = B // n_micro
    dt = cfg.dtype
    first = mesh.first_device

    # embed on the first device (replicated; cheap)
    x = (F.embedding(token_ids.to(first).long(), params["tok_emb"].to(first))
         + params["pos_emb"].to(first)[:L][None]).to(dt)
    x = _layer_norm(x, params["ln_in_scale"].to(first), params["ln_in_bias"].to(first), cfg.eps)
    m = mask.to(first)
    attn_bias = torch.where(m[:, None, None, :], 0.0, -1e30).float()
    micro_x = list(torch.chunk(x, n_micro))
    micro_ab = list(torch.chunk(attn_bias, n_micro))

    per = cfg.n_layers // pp
    names = [n[len(LAYER_PREFIX):] for n in params if n.startswith(LAYER_PREFIX)]
    lays = [_Layout(mesh, cfg, tp_axis=tp_axis, at={pp_axis: s}) for s in range(pp)]
    stage_dev = [lay.device() for lay in lays]
    stages = []
    for s, lay in enumerate(lays):
        layers = []
        for layer in range(s * per, (s + 1) * per):
            lp = {n: params[LAYER_PREFIX + n][layer] for n in names}
            layers.append((lp, *_layer_parts(lp, cfg, lay)))
        stages.append(layers)
    cache: Dict = {}

    def run_stage(s: int, h: torch.Tensor, ab: torch.Tensor) -> torch.Tensor:
        for lp, parts, experts in stages[s]:
            h = _layer([h], [ab], lp, parts, experts, cfg, lays[s], cache, 0)[0]
        return h

    # GPipe: at tick t stage s runs microbatch t - s (inside its window),
    # then every stage ships its activation to the next (last -> 0 discarded)
    buf: List[torch.Tensor] = [torch.zeros((Bm, L, cfg.hidden), dtype=dt, device=d)
                               for d in stage_dev]
    out: List[Optional[torch.Tensor]] = [None] * n_micro
    ring = [(d, (d + 1) % pp) for d in range(pp)]
    for t in range(n_micro + pp - 1):
        sent = list(buf)
        for s in range(pp):
            mb = t - s
            if not 0 <= mb < n_micro:
                continue
            h_in = micro_x[mb].to(stage_dev[s]) if s == 0 else buf[s]
            h_out = run_stage(s, h_in, micro_ab[mb].to(stage_dev[s]))
            sent[s] = h_out
            if s == pp - 1:
                out[mb] = h_out.to(first)
        buf = ppermute(sent, ring)

    first_norm = {k: params[k].to(first) for k in ("ln_out_scale", "ln_out_bias")}
    return pool(torch.cat(out), m, first_norm, cfg, normalize)


__all__ = ["pp_encode", "pipeline_param_shardings"]

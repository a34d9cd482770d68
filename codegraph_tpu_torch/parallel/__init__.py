"""Port of `codegraph_tpu/parallel/`: multi-device execution on a
single-controller mesh of `torch.device`s (`parallel/mesh.py`).

A corpus shards row-wise (or by IVF cell) over a mesh axis, every shard
scans its part with the port's kernels (K1/K2, K5/K6, K8) and the [B, k]
candidates merge; the encoder runs across the mesh with dp/sp/tp/ep
layouts, GPipe pipelining, ring attention and the routed mixture of
experts, and trains with `models/training.py` `make_sharded_train_step`.
"""

from codegraph_tpu_torch.parallel.mesh import default_mesh_shape, make_mesh
from codegraph_tpu_torch.parallel.pipeline import pp_encode
from codegraph_tpu_torch.parallel.ring_attention import ring_attention, sp_ring_encode
from codegraph_tpu_torch.parallel.sharded_ivf import ShardedIVFIndex
from codegraph_tpu_torch.parallel.sharded_ivfpq import ShardedIVFPQIndex
from codegraph_tpu_torch.parallel.sharded_search import (
    ShardedFlatIndex,
    ShardedInt8Index,
    sharded_topk,
    sharded_topk_2d,
    sharded_topk_hier,
    sharded_topk_int8,
)

__all__ = [
    "make_mesh",
    "default_mesh_shape",
    "ShardedFlatIndex",
    "ShardedInt8Index",
    "ShardedIVFIndex",
    "ShardedIVFPQIndex",
    "pp_encode",
    "ring_attention",
    "sp_ring_encode",
    "sharded_topk",
    "sharded_topk_2d",
    "sharded_topk_hier",
    "sharded_topk_int8",
]

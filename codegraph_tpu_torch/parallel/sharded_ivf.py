"""Port of `codegraph_tpu/parallel/sharded_ivf.py`: IVF cells partitioned
across the mesh, a per-shard probe and a k-way merge.

The [nlist, cap, D] cell tensor shards over its cell axis, so whole
inverted lists stay on their shard: each shard scores the queries against
its own centroids, probes its own top-nprobe cells (`index/ivf.py`
`ivf_search`, plain PyTorch on every device: the reference has no kernel
here), and the shards' candidates merge on the mesh's first device. The
ids are global rows, so on equal scores the merge keeps the lower shard's
candidate, not the lower id (ROADMAP section 3). Probing nprobe cells per
shard means recall at a given nprobe is at least the single index's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.core.errors import IndexNotBuilt
from codegraph_tpu_torch.index.ivf import IVFIndex, _empty_result, _to_host, ivf_search
from codegraph_tpu_torch.ops.similarity import l2_normalize
from codegraph_tpu_torch.parallel.mesh import Mesh, split_rows
from codegraph_tpu_torch.parallel.sharded_search import _gather_merge


def sharded_ivf_search(
    q: torch.Tensor,     # [B, D] replicated
    centroids,           # [nlist, D] sharded over `axis` (or its shards)
    x_lists,             # [nlist, cap, D] sharded over `axis`
    id_lists,            # [nlist, cap] sharded (GLOBAL row ids)
    bias_lists,          # [nlist, cap] sharded
    k: int,
    nprobe: int,
    mesh: Mesh,
    axis: str = "data",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores [B, k], global row ids [B, k]) on the mesh's first device."""
    devs = mesh.axis_devices(axis)
    parts = []
    cells = [c if isinstance(c, (list, tuple)) else split_rows(c, devs)
             for c in (centroids, x_lists, id_lists, bias_lists)]
    for cents, xl, il, bl in zip(*cells):
        local_nprobe = min(nprobe, cents.shape[0])
        parts.append(ivf_search(q.to(cents.device), cents, xl, il, bl, k, local_nprobe))
    return _gather_merge(parts, k, mesh.first_device)


class ShardedIVFIndex:
    """A single IVFIndex (on the mesh's first device) whose cell tensors are
    sharded over the mesh at search time.

    nlist rounds up to a multiple of the shard count; each shard's coarse
    quantizer covers its own cells only, so probe selection is local and
    only the (score, id) candidates leave a shard.
    """

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        axis: str = "data",
        nlist: int = 4096,
        nprobe: int = 64,
        metric: str = "cosine",
        dtype: str = "bfloat16",
        kmeans_iters: int = 10,
    ):
        self.mesh = mesh
        self.axis = axis
        n_shards = mesh.shape[axis]
        if nlist % n_shards != 0:
            nlist = ((nlist // n_shards) + 1) * n_shards
        self._base = IVFIndex(
            dim, nlist=nlist, nprobe=nprobe, metric=metric, dtype=dtype,
            kmeans_iters=kmeans_iters, device=mesh.first_device,
        )
        self.nprobe = min(nprobe, nlist)
        self._placed = False
        self._shards = None

    @property
    def dim(self) -> int:
        return self._base.dim

    def train(self, vectors) -> None:
        self._base.train(vectors)

    def add(self, vectors) -> np.ndarray:
        rows = self._base.add(vectors)
        self._placed = False
        return rows

    def delete(self, rows) -> None:
        self._base.delete(rows)
        self._placed = False

    def load_arrays(self, *args, **kwargs) -> None:
        """Adopt a built index's state (`IVFIndex.load_arrays`'s arguments)."""
        self._base.load_arrays(*args, **kwargs)
        self._placed = False

    def _place(self) -> None:
        if self._placed:
            return
        cents, x, ids, bias = self._base.arrays()
        if x is None:
            raise IndexNotBuilt("nothing added to the sharded IVF index")
        devs = self.mesh.axis_devices(self.axis)
        self._shards = [split_rows(t, devs) for t in (cents, x, ids, bias)]
        self._placed = True

    def search(self, queries, k: int, nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        if self._base.n_rows == 0:
            return _empty_result(queries, k)
        self._place()
        q = self._base._queries(queries)
        if self._base.metric == "cosine":
            q = l2_normalize(q)
        n_shards = self.mesh.shape[self.axis]
        np_eff = min(nprobe or self.nprobe, self._base.nlist // n_shards)
        return _to_host(*sharded_ivf_search(q, *self._shards, k, np_eff, self.mesh, self.axis))

    def stats(self) -> dict:
        return self._base.stats()

    def __len__(self) -> int:
        return len(self._base)


__all__ = ["ShardedIVFIndex", "sharded_ivf_search"]

"""Port of `codegraph_tpu/parallel/sharded_ivfpq.py`: the IVF-PQ capacity
tier times the mesh.

The [nlist, m, cap] residual-code tensor shards over its cell axis like
`ShardedIVFIndex` (whole inverted lists stay on their shard), the small
codebooks replicate, and each shard runs the coarse stage and the ADC scan
over its own cells: on a CUDA shard the scan is K8 (`ivfpq_search_cuda`,
csrc/ivfpq_adc.cu) over the shard's cells with their slice of the live
extents; on a CPU shard its plain version (`ivfpq_search`). The shards'
candidates merge on the mesh's first device, ties to the lower shard.

Refine modes compose with the mesh two ways:
- host refine (int8/f32 rows in host memory) applies after the merge: the
  merged ids are global rows.
- refine="int8_device" shards the int8 row bank by global row range: every
  shard scores exactly the candidates (of all shards) whose ids fall in its
  range, zero elsewhere, and a psum recombines them (each valid id is in
  exactly one range, so the sum is the exact score); the final top-k runs
  on the mesh's first device.

Inside a shard the JAX scan merges probe by probe (the carry first on a
tie) and K8 keeps the lower id, so ids are held equal outside ties only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.core.errors import IndexNotBuilt
from codegraph_tpu_torch.index.ivf import _empty_result, _to_host
from codegraph_tpu_torch.index.ivfpq import IVFPQIndex, ivfpq_search_cuda
from codegraph_tpu_torch.ops.similarity import l2_normalize
from codegraph_tpu_torch.ops.topk import NEG_INF, _sort_desc
from codegraph_tpu_torch.parallel.mesh import Mesh, all_gather, psum, split_rows
from codegraph_tpu_torch.parallel.sharded_search import _gather_merge

#: candidates per tile of the range-sharded exact rescore: the gathered
#: [B, tile, D] f32 rows stay ~100 MB at B=256, D=768
REFINE_TILE_C = 128


def _cell_shards(t, devs) -> List[torch.Tensor]:
    return list(t) if isinstance(t, (list, tuple)) else split_rows(t, devs)


def _scan_local(q, cents, cl, il, bl, books, k_fetch: int, nprobe: int, extents=None):
    """One shard's coarse + ADC scan over its cells -> (scores [B, k_fetch],
    global row ids [B, k_fetch]): K8 on a CUDA shard, plain on the CPU."""
    return ivfpq_search_cuda(q, cents, cl, il, bl, books, k_fetch, min(nprobe, cents.shape[0]),
                             extents=extents)


def _local_parts(q, centroids, code_lists, id_lists, bias_lists, books, k_fetch, nprobe, mesh,
                 axis, extents):
    devs = mesh.axis_devices(axis)
    cells = [_cell_shards(t, devs) for t in (centroids, code_lists, id_lists, bias_lists)]
    exts = _cell_shards(extents, devs) if extents is not None else [None] * len(devs)
    parts = []
    for (cents, cl, il, bl), ext in zip(zip(*cells), exts):
        dev = cents.device
        parts.append(_scan_local(q.to(dev), cents, cl, il, bl, books.to(dev), k_fetch, nprobe,
                                 extents=ext))
    return parts


def sharded_ivfpq_search(
    q: torch.Tensor,     # [B, D] replicated
    centroids,           # [nlist, D] sharded over `axis` (or its shards)
    code_lists,          # [nlist, m, cap] uint8, sharded
    id_lists,            # [nlist, cap] sharded (GLOBAL row ids)
    bias_lists,          # [nlist, cap] sharded
    books: torch.Tensor,  # [m, ksub, dsub] replicated
    k: int,
    nprobe: int,
    mesh: Mesh,
    axis: str = "data",
    extents=None,        # [nlist] int32 live slots per cell (K8 only), sharded
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores [B, k], global row ids [B, k]) on the mesh's first device."""
    parts = _local_parts(q, centroids, code_lists, id_lists, bias_lists, books, k, nprobe, mesh,
                         axis, extents)
    return _gather_merge(parts, k, mesh.first_device)


def _range_exact(q, cand, bank, scales, lo: int):
    """Exact scores of the candidates whose ids fall in this shard's bank
    range [lo, lo + rows), 0 elsewhere: int8 rows gathered, f32 dot, times
    the row's scale, in tiles of REFINE_TILE_C candidates."""
    rows_per = bank.shape[0]
    out = []
    for c0 in range(0, cand.shape[1], REFINE_TILE_C):
        ci = cand[:, c0: c0 + REFINE_TILE_C]
        in_r = (ci >= lo) & (ci < lo + rows_per)
        safe = torch.clamp(ci - lo, 0, rows_per - 1).long()
        rows = bank[safe].float()                                  # [B, tile, D]
        ex = torch.einsum("bd,bcd->bc", q, rows) * scales[:, 0][safe]
        out.append(torch.where(in_r, ex, 0.0))
    return torch.cat(out, dim=1)


def sharded_ivfpq_search_refined(
    q: torch.Tensor,
    centroids,
    code_lists,
    id_lists,
    bias_lists,
    books: torch.Tensor,
    bank,                # [N_pad, D] int8, sharded by ROW RANGE (or its shards)
    scales,              # [N_pad, 1] f32, sharded by ROW RANGE
    k: int,
    k_fetch: int,
    nprobe: int,
    mesh: Mesh,
    axis: str = "data",
    extents=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sharded IVF-PQ with the exact int8 refine on the shards' devices.

    Per shard: the ADC scan's top-k_fetch; every shard's candidate ids
    gathered ([B, n_shards * k_fetch], shard-major); the candidates in this
    shard's bank range rescored exactly; a psum recombines the disjoint
    ranges; the top-k of the exact scores on the mesh's first device."""
    devs = mesh.axis_devices(axis)
    parts = _local_parts(q, centroids, code_lists, id_lists, bias_lists, books, k_fetch, nprobe,
                         mesh, axis, extents)
    all_i = all_gather([i for _, i in parts])                     # [S, B, k_fetch] each
    banks, scs = _cell_shards(bank, devs), _cell_shards(scales, devs)
    rows_per = banks[0].shape[0]
    B = q.shape[0]
    partial = []
    for s, (ai, bk, sc) in enumerate(zip(all_i, banks, scs)):
        ci = ai.transpose(0, 1).reshape(B, -1)
        partial.append(_range_exact(q.to(bk.device), ci, bk, sc, s * rows_per))
    total = psum(partial)[0].to(mesh.first_device)
    ci = all_i[0].transpose(0, 1).reshape(B, -1).to(mesh.first_device)
    total = torch.where(ci >= 0, total, NEG_INF)
    return _sort_desc(total, ci, k)


class ShardedIVFPQIndex:
    """A single IVFPQIndex (on the mesh's first device) whose cell tensors
    shard over the mesh at search time. Probing is shard-local; only
    (score, id) candidates leave a shard. refine="int8_device" also shards
    the int8 row bank by global row range (`sharded_ivfpq_search_refined`);
    host refine (int8/f32) applies after the merge."""

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        axis: str = "data",
        nlist: int = 4096,
        nprobe: int = 64,
        m: int = 96,
        metric: str = "cosine",
        kmeans_iters: int = 10,
        pq_iters: int = 10,
        refine: str = "none",
        refine_factor: int = 4,
        opq: bool = False,
    ):
        self.mesh = mesh
        self.axis = axis
        n_shards = mesh.shape[axis]
        if nlist % n_shards != 0:
            nlist = ((nlist // n_shards) + 1) * n_shards
        self._base = IVFPQIndex(
            dim, nlist=nlist, nprobe=nprobe, m=m, metric=metric,
            kmeans_iters=kmeans_iters, pq_iters=pq_iters,
            refine=refine, refine_factor=refine_factor, opq=opq, device=mesh.first_device,
        )
        self.nprobe = min(nprobe, nlist)
        self._placed = False
        self._cells = None
        self._ext = None
        self._books = None
        self._bank = self._scales = None  # int8_device: row-range shards

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
        """Adopt a built index's state (`IVFPQIndex.load_arrays`'s arguments)."""
        self._base.load_arrays(*args, **kwargs)
        self._placed = False

    def _place(self) -> None:
        if self._placed:
            return
        base = self._base
        cents, x, ids, bias = base.arrays()
        if x is None:
            raise IndexNotBuilt("nothing added to the sharded IVF-PQ index")
        devs = self.mesh.axis_devices(self.axis)
        self._cells = [split_rows(t, devs) for t in (cents, x, ids, bias)]
        self._ext = split_rows(base._extents(), devs)
        self._books = base._books
        self._bank = self._scales = None
        if base.refine == "int8_device" and base._dev_chunks:
            bank, scales = base._dev_bank()
            S = self.mesh.shape[self.axis]
            pad = (-bank.shape[0]) % S
            if pad:
                bank = torch.cat([bank, torch.zeros((pad, bank.shape[1]), dtype=bank.dtype,
                                                    device=bank.device)])
                scales = torch.cat([scales, torch.ones((pad, 1), dtype=scales.dtype,
                                                       device=scales.device)])
            self._bank = split_rows(bank, devs)
            self._scales = split_rows(scales, devs)
        self._placed = True

    def search(self, queries, k: int, nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        base = self._base
        if base.n_rows == 0:
            return _empty_result(queries, k)
        self._place()
        q = base._queries(queries)
        if base.metric == "cosine":
            q = l2_normalize(q)
        if base._rot is not None:
            # OPQ: the placed centroids and codes live in the rotated space
            q = q @ base._rot
        n_shards = self.mesh.shape[self.axis]
        np_eff = min(nprobe or self.nprobe, base.nlist // n_shards)
        use_dev = base.refine == "int8_device" and bool(base._dev_chunks)
        use_host = base.refine in ("int8", "f32") and bool(base._raw_chunks)
        k_fetch = (max(k, min(k * base.refine_factor, base.list_cap * np_eff))
                   if (use_dev or use_host) else k)
        state = (q, *self._cells, self._books)
        if use_dev:
            return _to_host(*sharded_ivfpq_search_refined(
                *state, self._bank, self._scales, k, k_fetch, np_eff, self.mesh, self.axis,
                extents=self._ext))
        s_np, i_np = _to_host(*sharded_ivfpq_search(*state, k_fetch, np_eff, self.mesh,
                                                    self.axis, extents=self._ext))
        if not use_host:
            return s_np, i_np
        return base._refine_host(q.cpu().numpy(), s_np, i_np, k)

    def stats(self) -> dict:
        st = self._base.stats()
        st["shards"] = self.mesh.shape[self.axis]
        return st

    def __len__(self) -> int:
        return len(self._base)


__all__ = [
    "ShardedIVFPQIndex",
    "sharded_ivfpq_search",
    "sharded_ivfpq_search_refined",
]

"""Port of `codegraph_tpu/parallel/sharded_search.py`: corpus-sharded exact
search, a per-shard top-k and a k-way merge.

The corpus's rows shard over one mesh axis: shard s holds the contiguous
global rows [s * rows, (s + 1) * rows), as a row-range view of one tensor
where every shard lies on the same device (a mesh like `[cuda:0] * 8`) and
as a tensor on its own device otherwise. Every shard scans its rows with
the port's kernels: K1 (`streaming_topk_cuda`) for batches under 32 and K2
(`streaming_topk_cuda_qmajor`) from 32 on, as `FlatIndex` dispatches; K5
(`streaming_topk_int8_cuda`) and K6 (`..._qmajor`) for int8 rows. On CPU
tensors those wrappers run their plain versions. The shards' [B, k]
candidates, with global ids, merge in shard-major order under `lax.top_k`'s
rule (`_sort_desc`, a stable sort): on equal scores the lower shard wins,
and within a shard the lower id. The merged result lives on the mesh's
first device.

Padding follows the JAX package: capacity = round_up(n, n_shards * tile_n),
so every shard has the same rows, and k_eff = min(k, capacity / n_shards),
padded back to k with (NEG_INF, -1). A k above the kernels' MAX_K (1024)
raises on a CUDA mesh, as `FlatIndex` does.

`ShardedFlatIndex` scores f32 queries against its rows whatever their
dtype, as the JAX package's sharded scan does (an f32 q in the XLA scan
over bf16 rows): a bf16 index does not round its queries to bf16, unlike
`FlatIndex` (ROADMAP section 3). `ShardedInt8Index` rescores its int8
candidates exactly on the host from a retained f32 copy, as the
reference does.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from codegraph_tpu_torch.core.errors import DimensionMismatch
from codegraph_tpu_torch.core.padding import round_up
from codegraph_tpu_torch.index.flat import QMAJOR_MIN_BATCH
from codegraph_tpu_torch.ops.quantize import (
    quantize_rows,
    streaming_topk_int8_cuda,
    streaming_topk_int8_cuda_qmajor,
)
from codegraph_tpu_torch.ops.topk import (
    NEG_INF,
    _sort_desc,
    streaming_topk_cuda,
    streaming_topk_cuda_qmajor,
)
from codegraph_tpu_torch.parallel.mesh import Mesh, all_gather, split_rows

Shards = Union[torch.Tensor, Sequence[torch.Tensor]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _shards(x: Shards, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """Per-shard tensors: a list as given (one per device), or a full tensor
    cut into row ranges (`split_rows`)."""
    if torch.is_tensor(x):
        return split_rows(x, devices)
    if len(x) != len(devices):
        raise ValueError(f"{len(x)} shards for a mesh axis of {len(devices)}")
    return list(x)


def _scan(q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int, tile_n: int):
    """One shard's exact top-k: K1 for B < 32, K2 from 32 on (plain on CPU)."""
    kernel = streaming_topk_cuda_qmajor if q.shape[0] >= QMAJOR_MIN_BATCH else streaming_topk_cuda
    return kernel(q, x, bias, k, tile_n=tile_n)


def _global_ids(i: torch.Tensor, offset: int) -> torch.Tensor:
    return torch.where(i >= 0, i + offset, -1)


def merge_shards(all_s: torch.Tensor, all_i: torch.Tensor, k: int):
    """[n, B, k'] candidates of n shards -> top-k over the shard-major
    concat per query, ties to the lower position (`lax.top_k`)."""
    n, B, kk = all_s.shape
    cs = all_s.transpose(0, 1).reshape(B, n * kk)
    ci = all_i.transpose(0, 1).reshape(B, n * kk)
    return _sort_desc(cs, ci, k)


def _gather_merge(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]], k: int, device):
    """all_gather of per-shard (scores, global ids), merged once on `device`."""
    s = all_gather([p[0].to(device) for p in parts])[0]
    i = all_gather([p[1].to(device) for p in parts])[0]
    return merge_shards(s, i, k)


def sharded_topk(
    q: torch.Tensor,     # [B, D] replicated
    x: Shards,           # [N_pad, D], or its n_shards row ranges
    bias: Shards,        # [N_pad], or its n_shards ranges
    k: int,
    mesh: Mesh,
    axis: str = "data",
    tile_n: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores [B, k], global row ids [B, k]) on the mesh's first device."""
    devs = mesh.axis_devices(axis)
    xs, bs = _shards(x, devs), _shards(bias, devs)
    n_shard_rows = xs[0].shape[0]
    parts = []
    for shard, (xs_, bs_) in enumerate(zip(xs, bs)):
        s, i = _scan(q.to(xs_.device), xs_, bs_, k, tile_n)
        parts.append((s, _global_ids(i, shard * n_shard_rows)))
    return _gather_merge(parts, k, mesh.first_device)


def sharded_topk_2d(
    q: torch.Tensor,     # [B, D], B % q_shards == 0
    x: Shards,           # [N_pad, D] sharded over data_axis
    bias: Shards,
    k: int,
    mesh: Mesh,
    q_axis: str = "q",
    data_axis: str = "data",
    tile_n: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D sharded search: query rows split over q_axis, corpus rows over
    data_axis; the device at (q=a, data=d) scans query shard a against
    corpus shard d, and each query shard merges over its data ring. Returns
    the query shards' results joined in order, on the mesh's first device."""
    n_q = mesh.shape[q_axis]
    if q.shape[0] % n_q:
        raise ValueError(f"B={q.shape[0]} must divide by the {q_axis} axis ({n_q})")
    xs = _shards(x, mesh.axis_devices(data_axis))
    bs = _shards(bias, mesh.axis_devices(data_axis))
    n_shard_rows = xs[0].shape[0]
    out_s, out_i = [], []
    for a, qa in enumerate(torch.chunk(q, n_q)):
        parts = []
        for d, (xs_, bs_) in enumerate(zip(xs, bs)):
            dev = mesh.device(**{q_axis: a, data_axis: d})
            s, i = _scan(qa.to(dev), xs_.to(dev), bs_.to(dev), k, tile_n)
            parts.append((s, _global_ids(i, d * n_shard_rows)))
        s, i = _gather_merge(parts, k, mesh.device(**{q_axis: a}))
        out_s.append(s.to(mesh.first_device))
        out_i.append(i.to(mesh.first_device))
    return torch.cat(out_s), torch.cat(out_i)


def sharded_topk_hier(
    q: torch.Tensor,     # [B, D] replicated
    x: Shards,           # [N_pad, D] sharded over (dcn_axis, ici_axis)
    bias: Shards,
    k: int,
    mesh: Mesh,
    ici_axis: str = "ici",
    dcn_axis: str = "dcn",
    tile_n: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hierarchical merge: rows shard over (dcn, ici) flattened host-major
    (shard = host * n_ici + chip); each host merges its chips' candidates
    (level 1), then the hosts' sets merge (level 2)."""
    n_ici, n_dcn = mesh.shape[ici_axis], mesh.shape[dcn_axis]
    devs = [mesh.device(**{dcn_axis: h, ici_axis: c}) for h in range(n_dcn) for c in range(n_ici)]
    xs, bs = _shards(x, devs), _shards(bias, devs)
    n_shard_rows = xs[0].shape[0]
    hosts = []
    for h in range(n_dcn):
        parts = []
        for c in range(n_ici):
            shard = h * n_ici + c
            s, i = _scan(q.to(devs[shard]), xs[shard], bs[shard], k, tile_n)
            parts.append((s, _global_ids(i, shard * n_shard_rows)))
        hosts.append(_gather_merge(parts, k, mesh.device(**{dcn_axis: h})))
    return _gather_merge(hosts, k, mesh.first_device)


def _normalize_rows(v: torch.Tensor) -> torch.Tensor:
    """v / |v| per row where |v| > 1e-12 (the reference's numpy normalize)."""
    norms = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    return torch.where(norms > 1e-12, v / norms, v)


def _query_tensor(queries, dim: int, device) -> torch.Tensor:
    q = torch.as_tensor(queries).to(device).float()
    if q.dim() == 1:
        q = q[None, :]
    if q.shape[1] != dim:
        raise DimensionMismatch(dim, q.shape[1])
    return q


def _empty(queries, k: int):
    B = np.asarray(queries).shape[0] if not torch.is_tensor(queries) else queries.shape[0]
    return (np.full((B, k), float(NEG_INF), np.float32), np.full((B, k), -1, np.int32))


class _RowShards:
    """[capacity, ...] rows in n equal row ranges, one per device: one tensor
    with a view per shard where every shard lies on one device, else a
    tensor per shard."""

    def __init__(self, devices: Sequence[torch.device], cap: int, tail: Tuple[int, ...],
                 dtype: torch.dtype, fill: float):
        self.devices = list(devices)
        self.rows = cap // len(devices)
        if len(set(self.devices)) == 1:
            self.full = torch.full((cap, *tail), fill, dtype=dtype, device=self.devices[0])
            self.shards = list(torch.chunk(self.full, len(devices)))
        else:
            self.full = None
            self.shards = [torch.full((self.rows, *tail), fill, dtype=dtype, device=d)
                           for d in self.devices]

    def write(self, start: int, values: torch.Tensor) -> None:
        """Global rows [start, start + len(values)) = values."""
        end = start + values.shape[0]
        for s, shard in enumerate(self.shards):
            lo, hi = max(start, s * self.rows), min(end, (s + 1) * self.rows)
            if lo < hi:
                shard[lo - s * self.rows: hi - s * self.rows].copy_(values[lo - start: hi - start])

    def read(self, start: int, end: int) -> List[torch.Tensor]:
        """Global rows [start, end) as per-shard pieces, in order."""
        out = []
        for s, shard in enumerate(self.shards):
            lo, hi = max(start, s * self.rows), min(end, (s + 1) * self.rows)
            if lo < hi:
                out.append(shard[lo - s * self.rows: hi - s * self.rows])
        return out

    def set(self, rows: np.ndarray, value: float) -> None:
        """Entries at global `rows` = value."""
        for s, shard in enumerate(self.shards):
            mine = rows[(rows >= s * self.rows) & (rows < (s + 1) * self.rows)] - s * self.rows
            if mine.size:
                shard[torch.as_tensor(mine, device=shard.device)] = value

    def copy_from(self, other: "_RowShards", n: int) -> None:
        """Global rows [0, n) of another layout."""
        pos = 0
        for piece in other.read(0, n):
            self.write(pos, piece)
            pos += piece.shape[0]


class ShardedFlatIndex:
    """Flat exact index sharded row-wise over a 1-D mesh axis.

    Rows pad up to a multiple of n_shards * tile_n so that each shard holds
    the same rows. Tombstone deletes via the sharded bias vector.
    """

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        axis: str = "data",
        metric: str = "cosine",
        dtype: str = "float32",
        tile_n: int = 1024,
    ):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        self.dim = int(dim)
        self.mesh = mesh
        self.axis = axis
        self.metric = metric
        self.dtype = _DTYPES[dtype]
        self.tile_n = int(tile_n)
        self.n_shards = mesh.shape[axis]
        self.devices = mesh.axis_devices(axis)
        self.device = mesh.first_device  # where queries, merges and results live
        self.n_rows = 0
        self.n_live = 0
        self.capacity = 0
        self._x: Optional[_RowShards] = None
        self._bias: Optional[_RowShards] = None

    # -- ingest ------------------------------------------------------------

    def _prepare(self, vectors) -> torch.Tensor:
        v = torch.as_tensor(vectors)
        if v.dim() != 2 or v.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, v.shape[1] if v.dim() == 2 else -1)
        return v

    def _store(self, start: int, v: torch.Tensor, chunk: int = 1 << 20) -> None:
        """Write rows (normalized for cosine, cast to the storage dtype) in
        chunks, so that no full-size f32 temporary is made."""
        for c0 in range(0, v.shape[0], chunk):
            part = v[c0: c0 + chunk].to(self.devices[0]).float()
            if self.metric == "cosine":
                part = _normalize_rows(part)
            self._x.write(start + c0, part.to(self.dtype))
        self._bias.write(start, torch.zeros(v.shape[0], dtype=torch.float32,
                                            device=self.devices[0]))

    def _alloc(self, cap: int) -> Tuple[_RowShards, _RowShards]:
        return (_RowShards(self.devices, cap, (self.dim,), self.dtype, 0.0),
                _RowShards(self.devices, cap, (), torch.float32, NEG_INF))

    def build(self, vectors) -> np.ndarray:
        """Place the full corpus sharded across the mesh (numpy array or
        tensor, CUDA tensors included). Returns row ids."""
        v = self._prepare(vectors)
        n = v.shape[0]
        cap = round_up(max(n, 1), self.n_shards * self.tile_n)
        self._x = self._bias = None
        self._x, self._bias = self._alloc(cap)
        self._store(0, v)
        self.capacity = cap
        self.n_rows = n
        self.n_live = n
        return np.arange(n, dtype=np.int64)

    def add(self, vectors) -> np.ndarray:
        """Append rows; past the capacity every shard is laid out again at
        max(need, 1.5 x capacity), rounded to n_shards * tile_n."""
        if self._x is None:
            return self.build(vectors)
        v = self._prepare(vectors)
        n = v.shape[0]
        rows = np.arange(self.n_rows, self.n_rows + n, dtype=np.int64)
        need = self.n_rows + n
        if need > self.capacity:
            cap = round_up(max(need, int(self.capacity * 1.5)), self.n_shards * self.tile_n)
            x, bias = self._alloc(cap)
            x.copy_from(self._x, self.n_rows)
            bias.copy_from(self._bias, self.n_rows)
            self._x, self._bias = x, bias
            self.capacity = cap
        self._store(self.n_rows, v)
        self.n_rows = need
        self.n_live += n
        return rows

    def delete(self, rows) -> None:
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        self._bias.set(rows, NEG_INF)
        self.n_live -= int(rows.size)

    # -- query -------------------------------------------------------------

    @property
    def x_shards(self) -> List[torch.Tensor]:
        """The shards' rows, [capacity / n_shards, D] each (views, not copies)."""
        return self._x.shards

    @property
    def bias_shards(self) -> List[torch.Tensor]:
        return self._bias.shards

    def _shard_bias(self, extra_bias) -> List[torch.Tensor]:
        """The tombstone bias, plus a [n <= capacity] filter mask by global
        row (0 allowed / NEG_INF not) laid out like the rows."""
        if extra_bias is None:
            return self._bias.shards
        eb = torch.zeros(self.capacity, dtype=torch.float32)
        src = torch.as_tensor(extra_bias, dtype=torch.float32).cpu()
        n = min(src.shape[0], self.capacity)
        eb[:n] = src[:n]
        return [b + e.to(b.device) for b, e in zip(self._bias.shards,
                                                  torch.chunk(eb, self.n_shards))]

    def search(self, queries, k: int, extra_bias=None) -> Tuple[np.ndarray, np.ndarray]:
        if self._x is None or self.n_rows == 0:
            return _empty(queries, k)
        q = _query_tensor(queries, self.dim, self.device)
        if self.metric == "cosine":
            q = _normalize_rows(q)
        k_eff = min(k, self.capacity // self.n_shards)
        s, i = sharded_topk(q.contiguous(), self._x.shards, self._shard_bias(extra_bias), k_eff,
                            self.mesh, self.axis,
                            tile_n=min(self.tile_n, self.capacity // self.n_shards))
        s_np, i_np = s.cpu().numpy(), i.cpu().numpy()
        i_np = np.where(s_np <= float(NEG_INF) / 2, -1, i_np).astype(np.int32)
        if k_eff < k:
            s_np = np.pad(s_np, ((0, 0), (0, k - k_eff)), constant_values=float(NEG_INF))
            i_np = np.pad(i_np, ((0, 0), (0, k - k_eff)), constant_values=-1)
        return s_np, i_np

    def __len__(self) -> int:
        return self.n_live


def _scan_int8(qv, qs, xv, xs, bias, k: int, tile_n: int):
    """One shard's int8 top-k: K5 for B < 32, K6 from 32 on (plain on CPU)."""
    kernel = (streaming_topk_int8_cuda_qmajor if qv.shape[0] >= QMAJOR_MIN_BATCH
              else streaming_topk_int8_cuda)
    return kernel(qv, qs, xv, xs, bias, k, tile_n=tile_n)


def sharded_topk_int8(
    qv: torch.Tensor,    # [B, D] int8 replicated
    qs: torch.Tensor,    # [B] f32 replicated
    xv: Shards,          # [N_pad, D] int8 sharded over `axis`
    xs: Shards,          # [N_pad] f32 sharded
    bias: Shards,        # [N_pad] f32 sharded
    k: int,
    mesh: Mesh,
    axis: str = "data",
    tile_n: int = 2048,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 per-shard scan + k-way merge, on the mesh's first device."""
    devs = mesh.axis_devices(axis)
    xv_s, xs_s, b_s = _shards(xv, devs), _shards(xs, devs), _shards(bias, devs)
    n_shard_rows = xv_s[0].shape[0]
    parts = []
    for shard, (v, sc, b) in enumerate(zip(xv_s, xs_s, b_s)):
        s, i = _scan_int8(qv.to(v.device), qs.to(v.device), v, sc, b, k, tile_n)
        parts.append((s, _global_ids(i, shard * n_shard_rows)))
    return _gather_merge(parts, k, mesh.first_device)


class ShardedInt8Index:
    """int8-quantized corpus sharded row-wise + host-side f32 rescore.

    Per-shard int8 scan (K5/K6), the k-way merge for the candidate set,
    then an exact f32 rescore of the top `rescore_k` on the host from the
    retained f32 copy (the candidates are few, B x rescore_k rows).
    """

    def __init__(
        self,
        dim: int,
        mesh: Mesh,
        axis: str = "data",
        metric: str = "cosine",
        rescore_k: int = 100,
        tile_n: int = 2048,
    ):
        self.dim = int(dim)
        self.mesh = mesh
        self.axis = axis
        self.metric = metric
        self.rescore_k = int(rescore_k)
        self.tile_n = int(tile_n)
        self.n_shards = mesh.shape[axis]
        self.devices = mesh.axis_devices(axis)
        self.device = mesh.first_device
        self.n_rows = 0
        self.n_live = 0
        self.capacity = 0
        self._qv = self._qs = self._bias = None
        self._host_f32: Optional[np.ndarray] = None  # rescore copy

    def build(self, vectors, chunk: int = 1 << 20) -> np.ndarray:
        v = torch.as_tensor(vectors)
        if v.dim() != 2 or v.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, v.shape[1] if v.dim() == 2 else -1)
        n = v.shape[0]
        cap = round_up(max(n, 1), self.n_shards * self.tile_n)
        self._qv = self._qs = self._bias = self._host_f32 = None
        self._qv = _RowShards(self.devices, cap, (self.dim,), torch.int8, 0)
        self._qs = _RowShards(self.devices, cap, (), torch.float32, 0.0)
        self._bias = _RowShards(self.devices, cap, (), torch.float32, NEG_INF)
        host = np.zeros((cap, self.dim), np.float32)
        for c0 in range(0, n, chunk):
            part = v[c0: c0 + chunk].to(self.devices[0]).float()
            if self.metric == "cosine":
                part = _normalize_rows(part)
            qv, qs = quantize_rows(part)
            self._qv.write(c0, qv)
            self._qs.write(c0, qs)
            host[c0: c0 + part.shape[0]] = part.cpu().numpy()
        self._bias.write(0, torch.zeros(n, dtype=torch.float32, device=self.devices[0]))
        self._host_f32 = host
        self.capacity = cap
        self.n_rows = n
        self.n_live = n
        return np.arange(n, dtype=np.int64)

    def delete(self, rows) -> None:
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        self._bias.set(rows, NEG_INF)
        self.n_live -= int(rows.size)

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._qv is None or self.n_rows == 0:
            return _empty(queries, k)
        q = _query_tensor(queries, self.dim, self.device)
        if self.metric == "cosine":
            q = _normalize_rows(q)
        cand_k = min(max(k, self.rescore_k), self.capacity // self.n_shards)
        qv, qs = quantize_rows(q)
        s, i = sharded_topk_int8(qv, qs, self._qv.shards, self._qs.shards, self._bias.shards,
                                 cand_k, self.mesh, self.axis,
                                 tile_n=min(self.tile_n, self.capacity // self.n_shards))
        i_np = i.cpu().numpy()
        q_np = q.cpu().numpy()
        # exact f32 rescore host-side over the small candidate set
        safe = np.maximum(i_np, 0)
        cand_vecs = self._host_f32[safe]                 # [B, C, D]
        exact = np.einsum("bd,bcd->bc", q_np, cand_vecs)
        exact = np.where(i_np >= 0, exact, float(NEG_INF))
        order = np.argsort(-exact, axis=1)[:, :k]
        out_s = np.take_along_axis(exact, order, axis=1).astype(np.float32)
        out_i = np.take_along_axis(i_np, order, axis=1)
        out_i = np.where(out_s <= float(NEG_INF) / 2, -1, out_i)
        return out_s, out_i

    def __len__(self) -> int:
        return self.n_live


__all__ = [
    "ShardedFlatIndex",
    "ShardedInt8Index",
    "sharded_topk",
    "sharded_topk_2d",
    "sharded_topk_hier",
    "sharded_topk_int8",
    "merge_shards",
]

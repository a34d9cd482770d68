"""Device-resident flat (exact) vector index.

Port of `codegraph_tpu/index/flat.py`. The corpus lives as one padded
[capacity, D] matrix on the device; dynamic add/delete keeps the layout
via capacity padding + a NEG_INF bias vector (tombstones). Searches run
the exact streaming top-k: kernel K1 for batches under 32 and K2 for
batches of 32 and more (`ops/topk.py`), on a CUDA index; their plain
PyTorch version on a CPU index. A search records its host steps as
spans (`utils/perfmon.py`): `index.search` (n = B) and inside it
`index.upload`, `index.prepare`, `index.scan`, `index.copy_back`,
`index.post`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.core.errors import DimensionMismatch
from codegraph_tpu_torch.core.padding import aligned_rows, combine_bias, grow_capacity
from codegraph_tpu_torch.ops.similarity import l2_normalize
from codegraph_tpu_torch.ops.topk import (
    DEFAULT_TILE_N,
    NEG_INF,
    streaming_topk_cuda,
    streaming_topk_cuda_qmajor,
)
from codegraph_tpu_torch.utils.perfmon import span

#: batches of this many queries or more take K2 (corpus read once per
#: call for many queries), smaller ones K1
QMAJOR_MIN_BATCH = 32

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _as_tensor(a) -> torch.Tensor:
    """Tensor view of a numpy array (read-only memory maps are copied)."""
    if torch.is_tensor(a):
        return a
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


def _finish(s_np: np.ndarray, i_np: np.ndarray, k: int, k_eff: int):
    """Rows of dead or missing hits set to -1, both padded to k columns."""
    dead = s_np <= float(NEG_INF) / 2
    i_np = np.where(dead, -1, i_np).astype(np.int32)
    if k_eff < k:
        s_np = np.pad(s_np, ((0, 0), (0, k - k_eff)), constant_values=float(NEG_INF))
        i_np = np.pad(i_np, ((0, 0), (0, k - k_eff)), constant_values=-1)
    return s_np, i_np


def resolve_device(device) -> torch.device:
    """torch.device for `device`; asking for CUDA without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class FlatIndex:
    """Exact top-k index over a device-resident embedding matrix.

    metric: "cosine" normalizes rows and queries at ingest; "dot" stores raw.
    dtype:  storage dtype ("float32" | "bfloat16"); scores always f32.
    device: "cuda" (default) or "cpu".
    """

    def __init__(
        self,
        dim: int,
        metric: str = "cosine",
        dtype: str = "float32",
        tile_n: int = DEFAULT_TILE_N,
        device="cuda",
    ):
        if metric not in ("cosine", "dot"):
            raise ValueError(f"unknown metric {metric!r}")
        if dtype == "int8":
            raise NotImplementedError(
                "FlatIndex holds float32 or bfloat16 rows; the int8 tier is "
                "Int8FlatIndex (index/int8_flat.py)")
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        self.dim = int(dim)
        self.metric = metric
        self.dtype = _DTYPES[dtype]
        self.tile_n = int(tile_n)
        self.device = resolve_device(device)
        self.capacity = 0
        self.n_rows = 0  # high-water mark (includes tombstones)
        self.n_live = 0
        self._x: Optional[torch.Tensor] = None  # [cap, D]
        self._bias: Optional[torch.Tensor] = None  # [cap] f32, 0 live / NEG_INF dead

    @property
    def dtype_name(self) -> str:
        return str(self.dtype).replace("torch.", "")

    # -- ingest ------------------------------------------------------------

    def _prepare(self, vectors) -> torch.Tensor:
        v = torch.as_tensor(vectors).to(self.device)
        if v.dim() != 2 or v.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, v.shape[1] if v.dim() == 2 else -1)
        v = v.float()
        if self.metric == "cosine":
            v = l2_normalize(v)
        return v.to(self.dtype)

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        name = self.dtype_name
        new_cap = grow_capacity(needed, self.capacity, self.tile_n, name)
        new_cap = aligned_rows(new_cap, name, self.tile_n)
        x = torch.zeros((new_cap, self.dim), dtype=self.dtype, device=self.device)
        bias = torch.full((new_cap,), NEG_INF, dtype=torch.float32, device=self.device)
        if self._x is not None and self.n_rows > 0:
            x[: self.n_rows] = self._x[: self.n_rows]
            bias[: self.n_rows] = self._bias[: self.n_rows]
        self._x, self._bias = x, bias
        self.capacity = new_cap

    def reserve(self, n_rows: int) -> None:
        """Pre-size capacity for an expected corpus: one allocation
        instead of 1.5x geometric growth (a growth step transiently holds
        the old and the new matrix)."""
        self._ensure_capacity(int(n_rows))

    def add(self, vectors) -> np.ndarray:
        """Append vectors (numpy array or tensor, CUDA tensors included);
        returns their row ids. Rows are written in place."""
        v = self._prepare(vectors)
        n = v.shape[0]
        if n == 0:
            return np.zeros((0,), np.int64)
        self._ensure_capacity(self.n_rows + n)
        rows = np.arange(self.n_rows, self.n_rows + n, dtype=np.int64)
        self._x[self.n_rows: self.n_rows + n] = v
        self._bias[self.n_rows: self.n_rows + n] = 0.0
        self.n_rows += n
        self.n_live += n
        return rows

    def delete(self, rows) -> None:
        """Tombstone rows (delete-then-insert incremental model)."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        self._bias[torch.as_tensor(rows, device=self.device)] = NEG_INF
        self.n_live -= int(rows.size)

    # -- query -------------------------------------------------------------

    def search(
        self, queries, k: int, extra_bias=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k rows per query. Returns (scores [B,k] f32, rows [B,k] i32);
        rows are -1 where fewer than k live vectors exist. extra_bias is an
        optional [n <= capacity] f32 filter mask (0 allowed / NEG_INF not)."""
        if self.n_rows == 0:
            B = np.asarray(queries).shape[0]
            return (
                np.full((B, k), float(NEG_INF), np.float32),
                np.full((B, k), -1, np.int32),
            )
        with span("index.search") as top:
            with span("index.upload"):
                q = torch.as_tensor(queries).to(self.device)
            with span("index.prepare"):
                q = q.float()
                if q.dim() == 1:
                    q = q[None, :]
                if q.shape[1] != self.dim:
                    raise DimensionMismatch(self.dim, q.shape[1])
                top.n = q.shape[0]
                if self.metric == "cosine":
                    q = l2_normalize(q)
                # a bf16 index scores bf16 queries (flat.py:171-175 of the JAX index)
                q = q.to(self.dtype).contiguous()
            with span("index.scan"):
                k_eff = min(k, self.capacity)
                bias = combine_bias(self._bias, extra_bias, self.capacity)
                kernel = (streaming_topk_cuda_qmajor if q.shape[0] >= QMAJOR_MIN_BATCH
                          else streaming_topk_cuda)
                s, i = kernel(q, self._x, bias, k_eff, tile_n=min(self.tile_n, self.capacity))
            with span("index.copy_back"):
                s_np, i_np = s.cpu().numpy(), i.cpu().numpy()
            with span("index.post"):
                return _finish(s_np, i_np, k, k_eff)

    def get_vectors(self, rows) -> np.ndarray:
        """Gather stored vectors (f32) for rescoring."""
        r = torch.as_tensor(np.asarray(rows, np.int64), device=self.device)
        return self._x[r].float().cpu().numpy()

    # -- state -------------------------------------------------------------

    def arrays(self):
        """(x, bias) device tensors for snapshotting."""
        return self._x, self._bias

    def load_arrays(self, x, bias, n_rows: int, n_live: int) -> None:
        """Adopt (x [cap, D], bias [cap]) from numpy arrays or tensors, e.g.
        the JAX index's arrays() or a snapshot."""
        x, bias = _as_tensor(x), _as_tensor(bias)
        if x.dim() != 2 or x.shape[1] != self.dim or bias.shape != (x.shape[0],):
            raise DimensionMismatch(self.dim, x.shape[1] if x.dim() == 2 else -1)
        self._x = x.to(device=self.device, dtype=self.dtype).contiguous()
        self._bias = bias.to(device=self.device, dtype=torch.float32).contiguous()
        self.capacity = int(self._x.shape[0])
        self.n_rows = int(n_rows)
        self.n_live = int(n_live)

    @classmethod
    def from_arrays(cls, x, bias, n_rows: int, n_live: int, metric: str = "cosine",
                    dtype: str = "float32", device="cuda") -> "FlatIndex":
        idx = cls(int(x.shape[1]), metric=metric, dtype=dtype, device=device)
        idx.load_arrays(x, bias, n_rows, n_live)
        return idx

    def __len__(self) -> int:
        return self.n_live


__all__ = ["FlatIndex", "QMAJOR_MIN_BATCH", "resolve_device"]

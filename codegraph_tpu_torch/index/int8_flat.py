"""int8 scalar-quantized flat index with high-precision rescore.

Port of `codegraph_tpu/index/int8_flat.py`. The corpus lives on the device
as a [capacity, D] int8 matrix with per-row scales, and optionally a
second [capacity, D] bf16 or f32 copy for the rescore stage. A search is
two stages: an exact int8 scan for the top max(k, rescore_k) candidates
(kernel K5 for batches under 32, K6 for 32 and more, `ops/quantize.py`, on
a CUDA index; their plain PyTorch version on a CPU index), then the
rescore of those candidates against the high-precision copy, truncated to
k. A search records its host steps as spans (`utils/perfmon.py`):
`index.search` (n = B) and inside it `index.upload`, `index.prepare`,
`index.scan`, `index.rescore`, `index.copy_back`, `index.post`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.core.errors import DimensionMismatch
from codegraph_tpu_torch.core.padding import aligned_rows, combine_bias, grow_capacity
from codegraph_tpu_torch.index.flat import (
    QMAJOR_MIN_BATCH,
    _as_tensor,
    _finish,
    resolve_device,
)
from codegraph_tpu_torch.ops.quantize import (
    DEFAULT_TILE_N,
    quantize_rows,
    rescore_topk,
    streaming_topk_int8_cuda,
    streaming_topk_int8_cuda_qmajor,
)
from codegraph_tpu_torch.ops.similarity import l2_normalize
from codegraph_tpu_torch.ops.topk import NEG_INF
from codegraph_tpu_torch.utils.perfmon import span

_RESCORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Int8FlatIndex:
    """Exact-scan index over an int8-quantized device-resident matrix.

    rescore_dtype: "float32" | "bfloat16" | None. When set, a second
    [cap, D] matrix in that dtype is kept for the rescore stage; None
    skips rescoring (pure int8 ranking).
    device: "cuda" (default) or "cpu".
    """

    def __init__(
        self,
        dim: int,
        metric: str = "cosine",
        rescore_dtype: Optional[str] = "bfloat16",
        rescore_k: int = 100,
        tile_n: int = DEFAULT_TILE_N,
        device="cuda",
    ):
        if metric not in ("cosine", "dot"):
            raise ValueError(f"unknown metric {metric!r}")
        if rescore_dtype is not None and rescore_dtype not in _RESCORE_DTYPES:
            raise ValueError(f"unknown rescore_dtype {rescore_dtype!r}")
        self.dim = int(dim)
        self.metric = metric
        self.rescore_dtype = _RESCORE_DTYPES[rescore_dtype] if rescore_dtype else None
        self.rescore_k = int(rescore_k)
        self.tile_n = int(tile_n)
        self.device = resolve_device(device)
        self.capacity = 0
        self.n_rows = 0  # high-water mark (includes tombstones)
        self.n_live = 0
        self._q: Optional[torch.Tensor] = None  # [cap, D] int8
        self._s: Optional[torch.Tensor] = None  # [cap] f32 per-row scales
        self._r: Optional[torch.Tensor] = None  # [cap, D] rescore matrix
        self._bias: Optional[torch.Tensor] = None  # [cap] f32, 0 live / NEG_INF dead

    # -- ingest ------------------------------------------------------------

    def _prepare(self, vectors) -> torch.Tensor:
        v = torch.as_tensor(vectors).to(self.device)
        if v.dim() != 2 or v.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, v.shape[1] if v.dim() == 2 else -1)
        v = v.float()
        if self.metric == "cosine":
            v = l2_normalize(v)
        return v

    def reserve(self, n_rows: int) -> None:
        """Pre-size capacity for an expected corpus: one allocation of each
        bank instead of 1.5x geometric growth (a growth step transiently
        holds the old and the new banks)."""
        self._ensure_capacity(int(n_rows))

    def _ensure_capacity(self, needed: int) -> None:
        if needed <= self.capacity:
            return
        new_cap = grow_capacity(needed, self.capacity, self.tile_n, "int8")
        new_cap = aligned_rows(new_cap, "int8", self.tile_n)
        dev = self.device
        q = torch.zeros((new_cap, self.dim), dtype=torch.int8, device=dev)
        s = torch.zeros((new_cap,), dtype=torch.float32, device=dev)
        bias = torch.full((new_cap,), NEG_INF, dtype=torch.float32, device=dev)
        r = (torch.zeros((new_cap, self.dim), dtype=self.rescore_dtype, device=dev)
             if self.rescore_dtype is not None else None)
        n = self.n_rows
        if self._q is not None and n > 0:
            q[:n] = self._q[:n]
            s[:n] = self._s[:n]
            bias[:n] = self._bias[:n]
            if r is not None:
                r[:n] = self._r[:n]
        self._q, self._s, self._r, self._bias = q, s, r, bias
        self.capacity = new_cap

    def add(self, vectors) -> np.ndarray:
        """Append vectors (numpy array or tensor, CUDA tensors included);
        returns their row ids. Each block is quantized and written in place
        into the banks."""
        v = self._prepare(vectors)
        n = v.shape[0]
        if n == 0:
            return np.zeros((0,), np.int64)
        self._ensure_capacity(self.n_rows + n)
        off = self.n_rows
        rows = np.arange(off, off + n, dtype=np.int64)
        qv, qs = quantize_rows(v)
        self._q[off: off + n] = qv
        self._s[off: off + n] = qs
        self._bias[off: off + n] = 0.0
        if self._r is not None:
            self._r[off: off + n] = v.to(self.rescore_dtype)
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
        """Two-stage search: int8 scan for the top max(k, rescore_k)
        candidates, then high-precision rescore and truncate to k. Returns
        (scores [B,k] f32, rows [B,k] i32); rows are -1 where fewer than k
        live vectors exist. extra_bias is an optional [n <= capacity] f32
        filter mask (0 allowed / NEG_INF not)."""
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
                qv, qs = quantize_rows(q)
            with span("index.scan"):
                cand_k = min(max(k, self.rescore_k), self.capacity)
                bias = combine_bias(self._bias, extra_bias, self.capacity)
                kernel = (streaming_topk_int8_cuda_qmajor if q.shape[0] >= QMAJOR_MIN_BATCH
                          else streaming_topk_int8_cuda)
                s, i = kernel(qv, qs, self._q, self._s, bias, cand_k,
                              tile_n=min(self.tile_n, self.capacity))
            k_eff = min(k, cand_k)
            if self._r is not None:
                with span("index.rescore"):
                    s, i = rescore_topk(q, self._r, i, s, k_eff)
            else:
                s, i = s[:, :k_eff], i[:, :k_eff]
            with span("index.copy_back"):
                s_np, i_np = s.cpu().numpy(), i.cpu().numpy()
            with span("index.post"):
                return _finish(s_np, i_np, k, k_eff)

    # -- state -------------------------------------------------------------

    def arrays(self):
        """(q, s, r, bias) device tensors for snapshotting; r is None
        without a rescore copy."""
        return self._q, self._s, self._r, self._bias

    def load_arrays(self, q, s, r, bias, n_rows: int, n_live: int) -> None:
        """Adopt (q [cap, D] int8, s [cap], r [cap, D] or None, bias [cap])
        from numpy arrays or tensors, e.g. the JAX index's arrays() or a
        snapshot. r is cast to the rescore dtype (kept as given when the
        index has none, as the reference does)."""
        q, s, bias = _as_tensor(q), _as_tensor(s), _as_tensor(bias)
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, q.shape[1] if q.dim() == 2 else -1)
        if s.shape != (q.shape[0],) or bias.shape != (q.shape[0],):
            raise ValueError(f"scales {tuple(s.shape)} and bias {tuple(bias.shape)} must be "
                             f"[{q.shape[0]}]")
        dev = self.device
        self._q = q.to(device=dev, dtype=torch.int8).contiguous()
        self._s = s.to(device=dev, dtype=torch.float32).contiguous()
        self._bias = bias.to(device=dev, dtype=torch.float32).contiguous()
        self._r = None
        if r is not None:
            r = _as_tensor(r)
            if r.shape != q.shape:
                raise ValueError(f"rescore rows {tuple(r.shape)} must match {tuple(q.shape)}")
            self._r = r.to(device=dev, dtype=self.rescore_dtype or r.dtype).contiguous()
        self.capacity = int(self._q.shape[0])
        self.n_rows = int(n_rows)
        self.n_live = int(n_live)

    def __len__(self) -> int:
        return self.n_live


__all__ = ["Int8FlatIndex"]

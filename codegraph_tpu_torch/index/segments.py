"""Port of `codegraph_tpu/index/segments.py`: the segmented incremental
index (append -> seal -> merge/compact) over the port's `FlatIndex`.

Reference: crates/codegraph-vector/src/incremental.rs:402-1021 —
IndexSegment append/seal (:86-150), prioritized UpdateBatch (:69-84),
background merge/compaction, stats (:198). Each segment is its own
device-resident FlatIndex on the index's device; the active segment absorbs
appends, sealing freezes it, and compaction concatenates sealed segments
into one matrix so that steady-state search scans one large [N, D] plus a
small active tail.

Search runs each non-empty segment's flat scan (K1 below 32 queries, K2
from 32) and merges on the host exactly as the JAX package does: after each
segment, `np.argsort(-scores)` over the running best and the segment's
top-k, so ties resolve as in the reference. Compaction gathers the sealed
segments' live rows on the device (the JAX package copies them through the
host); the rows, their order and the row map are the reference's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.index.flat import FlatIndex, resolve_device
from codegraph_tpu_torch.ops.topk import NEG_INF


@dataclass
class SegmentInfo:
    segment_id: int
    sealed: bool
    rows: int
    live: int
    created_at: float


class SegmentedIndex:
    """Append-optimized index with stable global rows.

    Global row = segment_base + local row; bases are fixed at segment
    creation (capacity-stride), so sealing/compaction never renumbers.
    """

    SEGMENT_STRIDE = 1 << 22  # max rows per segment id-space

    def __init__(
        self,
        dim: int,
        metric: str = "cosine",
        dtype: str = "float32",
        seal_threshold: int = 100_000,
        compact_min_segments: int = 4,
        device="cuda",
    ):
        self.dim = dim
        self.metric = metric
        self.dtype = dtype
        self.device = resolve_device(device)
        self.seal_threshold = seal_threshold
        self.compact_min_segments = compact_min_segments
        self._segments: List[FlatIndex] = []
        self._sealed: List[bool] = []
        self._created: List[float] = []
        self._new_segment()

    # -- segment lifecycle -------------------------------------------------

    def _new_segment(self) -> int:
        self._segments.append(
            FlatIndex(self.dim, metric=self.metric, dtype=self.dtype, device=self.device)
        )
        self._sealed.append(False)
        self._created.append(time.time())
        return len(self._segments) - 1

    @property
    def _active(self) -> int:
        return len(self._segments) - 1

    def seal_active(self) -> None:
        """Freeze the active segment and open a new one
        (incremental.rs:150 seal)."""
        if len(self._segments[self._active]) > 0:
            self._sealed[self._active] = True
            self._new_segment()

    # -- ingest ------------------------------------------------------------

    def add(self, vectors) -> np.ndarray:
        """Append vectors (numpy array or tensor) to the active segment;
        returns their global rows."""
        seg = self._active
        local = self._segments[seg].add(vectors)
        rows = seg * self.SEGMENT_STRIDE + local
        if self._segments[seg].n_rows >= self.seal_threshold:
            self.seal_active()
        return rows

    def delete(self, rows) -> None:
        rows = np.asarray(rows, np.int64)
        by_seg: Dict[int, List[int]] = {}
        for r in rows:
            by_seg.setdefault(int(r) // self.SEGMENT_STRIDE, []).append(
                int(r) % self.SEGMENT_STRIDE
            )
        for seg, local in by_seg.items():
            if seg < len(self._segments):
                self._segments[seg].delete(np.asarray(local, np.int64))

    # -- query -------------------------------------------------------------

    def search(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k global rows per query: (scores [B, k] f32, rows [B, k]
        int64, -1 where fewer than k live rows exist)."""
        q = np.atleast_2d(np.asarray(queries, np.float32))
        B = q.shape[0]
        best_s = np.full((B, k), float(NEG_INF), np.float32)
        best_i = np.full((B, k), -1, np.int64)
        for seg, index in enumerate(self._segments):
            if len(index) == 0:
                continue
            s, i = index.search(q, k)
            gi = np.where(i >= 0, i.astype(np.int64) + seg * self.SEGMENT_STRIDE, -1)
            cs = np.concatenate([best_s, s], axis=1)
            ci = np.concatenate([best_i, gi], axis=1)
            order = np.argsort(-cs, axis=1)[:, :k]
            best_s = np.take_along_axis(cs, order, axis=1)
            best_i = np.take_along_axis(ci, order, axis=1)
        return best_s, best_i

    # -- compaction --------------------------------------------------------

    def should_compact(self) -> bool:
        sealed = sum(1 for s in self._sealed if s)
        return sealed >= self.compact_min_segments

    def compact(self) -> Dict[int, int]:
        """Merge all sealed segments into one; returns {old_row: new_row}
        remap for the caller's row bookkeeping (the reference's merge
        phase; dead rows are dropped, reclaiming tombstone space)."""
        sealed_ids = [i for i, s in enumerate(self._sealed) if s]
        if len(sealed_ids) < 2:
            return {}
        vectors, remap_src = [], []
        for seg in sealed_ids:
            index = self._segments[seg]
            x, bias = index.arrays()
            if x is None:
                continue
            live = torch.nonzero(bias[: index.n_rows] > float(NEG_INF) / 2).flatten()
            vectors.append(x[live].float())
            remap_src.append(seg * self.SEGMENT_STRIDE + live.cpu().numpy().astype(np.int64))
        # same metric as the rest of the index: queries must be treated
        # identically across segments (re-normalizing already-normalized
        # rows is a no-op but for f32 rounding)
        merged = FlatIndex(self.dim, metric=self.metric, dtype=self.dtype, device=self.device)
        remap: Dict[int, int] = {}
        src = np.concatenate(remap_src) if remap_src else np.zeros((0,), np.int64)
        if src.size:
            local = merged.add(torch.cat(vectors))
        else:
            local = np.zeros((0,), np.int64)
        # rebuild the segment list: merged first, then unsealed tail
        tail = [
            (i, s) for i, s in enumerate(self._segments)
            if not self._sealed[i]
        ]
        new_segments = [merged] + [s for _, s in tail]
        new_sealed = [True] + [False] * len(tail)
        remap.update(zip(src.tolist(), local.tolist()))  # merged is segment 0
        # tail segments keep their indices shifted: old seg -> new position
        for new_pos, (old_seg, _) in enumerate(tail, start=1):
            for r in range(self._segments[old_seg].n_rows):
                remap[old_seg * self.SEGMENT_STRIDE + r] = (
                    new_pos * self.SEGMENT_STRIDE + r
                )
        self._segments = new_segments
        self._sealed = new_sealed
        self._created = [time.time()] * len(new_segments)
        return remap

    # -- stats -------------------------------------------------------------

    def stats(self) -> List[SegmentInfo]:
        return [
            SegmentInfo(
                segment_id=i, sealed=self._sealed[i],
                rows=self._segments[i].n_rows, live=len(self._segments[i]),
                created_at=self._created[i],
            )
            for i in range(len(self._segments))
        ]

    def __len__(self) -> int:
        return sum(len(s) for s in self._segments)


__all__ = ["SegmentedIndex", "SegmentInfo"]

"""IVF (inverted-file) index: k-means partitions + bucketed probe search.

Port of `codegraph_tpu/index/ivf.py`, plain PyTorch (the JAX package
runs it as XLA, with no Pallas kernel). Variable-length inverted lists
are a dense [nlist, list_cap, D] tensor on the device, with capacity-
bounded cells: a row goes to its nearest centroid's cell, spills to the
second nearest when that is full, and to the least-filled cell when both
are. Search is two stages:

  1. coarse: Q @ C^T -> top-nprobe cells per query
  2. probe:  for each of the nprobe steps gather one [B, list_cap, D]
             block of whole cells and merge its scores into the running
             top-k (`ivf_search`, the counterpart of `ivf_search_kernel`).

The spill assignment is sequential in the fill state. `spill_assign` is
the reference's loop in Python; a CUDA index runs the same loop compiled
(`spill_assign_host`, `csrc/ivf_spill.cu`), which `chip_smoke.py` holds
to the Python loop. The row -> (cell, pos) map is an index-ordered
[rows, 2] array instead of a dict.

One reference behaviour is reproduced on purpose: the indexer shrinks
`nlist` for tiny corpora after the index was made, but `_fill` keeps its
original length, so a third-choice spill (`argmin(fill)`) can pick a cell
>= nlist. The JAX scatter drops that row's write without a word; here the
row's (cell, pos) is recorded the same way and its write is skipped
(ROADMAP queue 3).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.core.errors import DimensionMismatch, IndexNotBuilt
from codegraph_tpu_torch.core.padding import round_up
from codegraph_tpu_torch.index.flat import _DTYPES, _as_tensor, resolve_device
from codegraph_tpu_torch.ops.kmeans import assign_clusters_topk, kmeans
from codegraph_tpu_torch.ops.similarity import l2_normalize
from codegraph_tpu_torch.ops.topk import NEG_INF, merge_topk

#: queries per probe-step gather in the plain searches: bounds the
#: [tile, list_cap, D] working set
SEARCH_TILE_B = 128


def _empty_result(queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
    B = np.asarray(queries).shape[0]
    return (np.full((B, k), float(NEG_INF), np.float32), np.full((B, k), -1, np.int32))


def _to_host(s: torch.Tensor, i: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """Scores and ids to numpy, with dead (NEG_INF) entries' ids at -1."""
    s_np, i_np = s.cpu().numpy(), i.cpu().numpy()
    return s_np, np.where(s_np <= float(NEG_INF) / 2, -1, i_np).astype(np.int32)


def coarse_probe(q: torch.Tensor, centroids: torch.Tensor, nprobe: int):
    """(scores [B, nprobe], cells [B, nprobe] int64) of the top-nprobe
    centroids per query, best first."""
    return torch.topk(q @ centroids.T, nprobe, dim=1)


def ivf_search(
    q: torch.Tensor,           # [B, D] f32
    centroids: torch.Tensor,   # [nlist, D] f32
    x_lists: torch.Tensor,     # [nlist, list_cap, D]
    id_lists: torch.Tensor,    # [nlist, list_cap] i32 (-1 pad)
    bias_lists: torch.Tensor,  # [nlist, list_cap] f32 (0 live / NEG_INF dead)
    k: int,
    nprobe: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (scores [B, k], global row ids [B, k])."""
    B = q.shape[0]
    _, probe_ids = coarse_probe(q, centroids, nprobe)
    top_s = torch.full((B, k), NEG_INF, dtype=torch.float32, device=q.device)
    top_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for p in range(nprobe):
        s_parts = []
        for b0 in range(0, B, SEARCH_TILE_B):
            cell = probe_ids[b0: b0 + SEARCH_TILE_B, p]
            xt = x_lists[cell].float()                        # [tb, cap, D]
            s_parts.append(torch.einsum("bd,bcd->bc", q[b0: b0 + SEARCH_TILE_B], xt)
                           + bias_lists[cell])
        cell = probe_ids[:, p]
        top_s, top_i = merge_topk(top_s, top_i, torch.cat(s_parts), id_lists[cell], k)
    return top_s, top_i


def batch_member_tiles(probe_ids: torch.Tensor, cells_u: torch.Tensor, tile_u: int):
    """member[b, u] (does query b probe cells_u[u]?) cut into tiles of
    tile_u cells: [(cells [tu], member [B, tu]), ...]. The pad value
    nlist never matches."""
    member = (probe_ids[:, :, None] == cells_u[None, None, :]).any(dim=1)  # [B, U]
    return [(cells_u[u0: u0 + tile_u], member[:, u0: u0 + tile_u])
            for u0 in range(0, cells_u.shape[0], tile_u)]


def ivf_batch_search(
    q: torch.Tensor,           # [B, D] f32
    probe_ids: torch.Tensor,   # [B, nprobe]
    cells_u: torch.Tensor,     # [U_pad] union of probed cells (pad = nlist)
    x_lists: torch.Tensor,     # [nlist, cap, D]
    id_lists: torch.Tensor,    # [nlist, cap] i32
    bias_lists: torch.Tensor,  # [nlist, cap] f32
    k: int,
    tile_u: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-shared IVF search (the counterpart of `ivf_batch_search_kernel`):
    gather each unique probed cell once and score it against the whole
    batch; a membership mask re-imposes each query's own nprobe cells.
    Same scores as `ivf_search`."""
    B = q.shape[0]
    nlist, cap = id_lists.shape
    top_s = torch.full((B, k), NEG_INF, dtype=torch.float32, device=q.device)
    top_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for cu, mem in batch_member_tiles(probe_ids, cells_u, tile_u):
        cu_safe = torch.clamp(cu, max=nlist - 1).long()
        s = torch.einsum("bd,ucd->buc", q, x_lists[cu_safe].float())
        s = s + bias_lists[cu_safe][None, :, :]
        s = s + torch.where(mem, 0.0, NEG_INF)[:, :, None]
        ids = id_lists[cu_safe].reshape(1, -1).expand(B, -1)
        top_s, top_i = merge_topk(top_s, top_i, s.reshape(B, -1), ids, k)
    return top_s, top_i


def union_cells(probe_ids: torch.Tensor, nlist: int, tile_u: int) -> torch.Tensor:
    """Unique probed cells, padded with nlist to tile_u * 2^j entries."""
    uniq = torch.unique(probe_ids)
    u_pad = tile_u
    while u_pad < uniq.numel():
        u_pad *= 2
    cells_u = torch.full((u_pad,), nlist, dtype=probe_ids.dtype, device=probe_ids.device)
    cells_u[: uniq.numel()] = uniq
    return cells_u


# ---------------------------------------------------------------------------
# capacity-bounded spill assignment
# ---------------------------------------------------------------------------


def spill_assign(top2: np.ndarray, fill: np.ndarray, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cell, pos) per row: first choice -> second -> least-filled cell
    (the lowest such index), in row order. Mutates `fill` (int64). The
    reference's loop, kept as the plain version of `spill_assign_host`."""
    n = top2.shape[0]
    assign = np.empty((n,), np.int64)
    pos = np.empty((n,), np.int64)
    for j in range(n):
        c = int(top2[j, 0])
        if fill[c] >= cap:
            c2 = int(top2[j, 1])
            c = c2 if fill[c2] < cap else int(np.argmin(fill))
        assign[j] = c
        pos[j] = fill[c]
        fill[c] += 1
    return assign, pos


_spill_lib = None


def spill_assign_host(top2: np.ndarray, fill: np.ndarray, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """`spill_assign` compiled (csrc/ivf_spill.cu, built on first use):
    the same (cell, pos) and the same update of `fill`."""
    global _spill_lib
    if _spill_lib is None:
        from codegraph_tpu_torch.ops import cuda_build

        lib = cuda_build.load("ivf_spill")
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        lib.ivf_spill_fill.argtypes = [p, ll, p, ll, ll, p, p]
        lib.ivf_spill_fill.restype = ctypes.c_int
        _spill_lib = lib
    if fill.dtype != np.int64 or not fill.flags.c_contiguous:
        raise ValueError("fill must be a contiguous int64 array (it is updated in place)")
    top2 = np.ascontiguousarray(top2, np.int32)
    n = top2.shape[0]
    assign = np.empty((n,), np.int64)
    pos = np.empty((n,), np.int64)
    err = _spill_lib.ivf_spill_fill(top2.ctypes.data, n, fill.ctypes.data, fill.shape[0], int(cap),
                                    assign.ctypes.data, pos.ctypes.data)
    if err != 0:
        raise ValueError(f"ivf_spill_fill: a cell id in top2 lies outside fill ({err})")
    return assign, pos


class IVFIndex:
    """k-means-partitioned approximate index over device-resident cells.

    capacity_factor: list_cap = capacity_factor * N/nlist (padded); adds
    that need more grow every cell geometrically (1.5x), or once with
    `reserve`. device: "cuda" (default) or "cpu".
    """

    def __init__(
        self,
        dim: int,
        nlist: int = 4096,
        nprobe: int = 64,
        metric: str = "cosine",
        dtype: str = "float32",
        kmeans_iters: int = 10,
        capacity_factor: float = 2.0,
        train_sample: int = 262_144,
        seed: int = 0,
        device="cuda",
    ):
        if metric not in ("cosine", "dot"):
            raise ValueError(f"unknown metric {metric!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        self.dim = int(dim)
        self.nlist = int(nlist)
        self.nprobe = min(int(nprobe), self.nlist)
        self.metric = metric
        self.dtype = _DTYPES[dtype]
        self.kmeans_iters = int(kmeans_iters)
        self.capacity_factor = float(capacity_factor)
        self.train_sample = int(train_sample)
        self.seed = int(seed)
        self.device = resolve_device(device)
        # search() never routes to search_batch for raw-vector cells (the
        # reference measured the per-query probe faster there)
        self.batch_share_threshold = float("inf")
        self.list_cap = 0
        self.n_rows = 0  # global rows ever assigned (includes tombstones)
        self.n_live = 0
        self._centroids: Optional[torch.Tensor] = None  # [nlist, D] f32
        self._x: Optional[torch.Tensor] = None          # [nlist, cap, D]
        self._ids: Optional[torch.Tensor] = None        # [nlist, cap] i32
        self._bias: Optional[torch.Tensor] = None       # [nlist, cap] f32
        # host-side bookkeeping
        self._fill = np.zeros((self.nlist,), np.int64)  # rows used per cell
        self._row_loc = np.full((0, 2), -1, np.int64)   # row -> (cell, pos)

    # -- build -------------------------------------------------------------

    def _prepare(self, vectors) -> torch.Tensor:
        v = torch.as_tensor(vectors).to(self.device)
        if v.dim() != 2 or v.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, v.shape[1] if v.dim() == 2 else -1)
        v = v.float()
        if self.metric == "cosine":
            v = l2_normalize(v)
        return v

    def _sample(self, v: torch.Tensor, n_keep: int) -> torch.Tensor:
        """The reference's training sample: the same numpy draw."""
        if v.shape[0] <= n_keep:
            return v
        sel = np.random.default_rng(self.seed).choice(v.shape[0], n_keep, replace=False)
        return v[torch.as_tensor(np.sort(sel), device=v.device)]

    def train(self, vectors) -> None:
        """k-means on (a sample of) the training vectors."""
        v = self._prepare(vectors)
        if v.shape[0] < self.nlist:
            raise ValueError(f"need >= nlist={self.nlist} train vectors, got {v.shape[0]}")
        v = self._sample(v, self.train_sample)
        tile = min(4096, round_up(v.shape[0], 8))
        self._centroids, _ = kmeans(v, self.nlist, n_iters=self.kmeans_iters,
                                    metric=self.metric, tile_n=tile, seed=self.seed)

    @property
    def is_trained(self) -> bool:
        return self._centroids is not None

    def _cell_cap(self, list_cap: int) -> int:
        return max(8, round_up(list_cap, 8))

    def _new_cells(self, list_cap: int) -> torch.Tensor:
        return torch.zeros((self.nlist, list_cap, self.dim), dtype=self.dtype, device=self.device)

    def _alloc(self, list_cap: int) -> None:
        """(Re)allocate cell storage at a new list_cap, preserving data."""
        list_cap = self._cell_cap(list_cap)
        x = self._new_cells(list_cap)
        ids = torch.full((self.nlist, list_cap), -1, dtype=torch.int32, device=self.device)
        bias = torch.full((self.nlist, list_cap), NEG_INF, dtype=torch.float32,
                          device=self.device)
        if self._x is not None and self.list_cap > 0:
            old = min(self.list_cap, list_cap)
            self._copy_cells(x, old)
            ids[:, :old] = self._ids[:, :old]
            bias[:, :old] = self._bias[:, :old]
        self._x, self._ids, self._bias = x, ids, bias
        self.list_cap = list_cap

    def _copy_cells(self, new: torch.Tensor, old: int) -> None:
        new[:, :old] = self._x[:, :old]

    def _target_cap(self, n_rows: int) -> int:
        """Cell capacity demanded by n_rows in all (shared by reserve and add)."""
        return max(8, int(np.ceil(self.capacity_factor * n_rows / self.nlist)))

    def reserve(self, n_rows: int) -> None:
        """Pre-size cell capacity for an expected corpus size: one
        allocation instead of geometric growth during a chunked build."""
        target_cap = self._target_cap(n_rows)
        if target_cap > self.list_cap:
            self._alloc(target_cap)

    def _store_values(self, v: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
        """What a cell stores per row (IVF-PQ stores residual codes)."""
        return v.to(self.dtype)

    def _scatter_payload(self, cells: torch.Tensor, pos: torch.Tensor, vals: torch.Tensor) -> None:
        """Write per-row payloads into cell storage, in place."""
        self._x[cells, pos] = vals

    def _spill(self, top2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        fn = spill_assign_host if self.device.type == "cuda" else spill_assign
        return fn(top2, self._fill, self.list_cap)

    def _remember(self, rows: np.ndarray, assign: np.ndarray, pos: np.ndarray) -> None:
        end = int(rows[-1]) + 1
        if end > self._row_loc.shape[0]:
            grown = np.full((max(end, int(self._row_loc.shape[0] * 1.5)), 2), -1, np.int64)
            grown[: self._row_loc.shape[0]] = self._row_loc
            self._row_loc = grown
        self._row_loc[rows, 0] = assign
        self._row_loc[rows, 1] = pos

    def add(self, vectors) -> np.ndarray:
        """Assign to the nearest cell (with capacity-bounded spill) and
        append; returns the rows' global ids."""
        if not self.is_trained:
            raise IndexNotBuilt("IVFIndex.train() must run before add()")
        v = self._prepare(vectors)
        n = v.shape[0]
        if n == 0:
            return np.zeros((0,), np.int64)
        top2 = assign_clusters_topk(
            v, self._centroids, None, tile_n=min(4096, round_up(n, 8)),
            metric="cosine" if self.metric == "cosine" else "dot",
            top=min(2, self.nlist),
        ).cpu().numpy()
        if top2.shape[1] == 1:  # nlist == 1: no second choice to spill to
            top2 = np.repeat(top2, 2, axis=1)

        # geometric growth (1.5x): each _alloc copies every cell
        target_cap = self._target_cap(self.n_rows + n)
        if target_cap > self.list_cap:
            self._alloc(max(target_cap, int(self.list_cap * 1.5)))

        rows = np.arange(self.n_rows, self.n_rows + n, dtype=np.int64)
        assign, pos = self._spill(top2)
        cells_t = torch.as_tensor(assign, device=self.device)
        vals = self._store_values(v, torch.clamp(cells_t, max=self.nlist - 1))
        # a cell >= nlist exists only in _fill (see the module docstring):
        # its row is recorded but not written, as the reference's scatter drops it
        keep = cells_t < self.nlist
        cells_k, pos_k = cells_t[keep], torch.as_tensor(pos, device=self.device)[keep]
        self._scatter_payload(cells_k, pos_k, vals[keep])
        self._ids[cells_k, pos_k] = torch.as_tensor(rows.astype(np.int32), device=self.device)[keep]
        self._bias[cells_k, pos_k] = 0.0
        self._remember(rows, assign, pos)
        self.n_rows += n
        self.n_live += n
        return rows

    def delete(self, rows) -> None:
        """Tombstone rows; a row the index never held raises KeyError."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        if rows.min() < 0 or rows.max() >= self._row_loc.shape[0]:
            raise KeyError(int(rows.max()))
        loc = self._row_loc[rows]
        if (loc[:, 0] < 0).any():
            raise KeyError(int(rows[loc[:, 0] < 0][0]))
        keep = loc[:, 0] < self.nlist
        cells = torch.as_tensor(loc[keep, 0], device=self.device)
        pos = torch.as_tensor(loc[keep, 1], device=self.device)
        self._bias[cells, pos] = NEG_INF
        self.n_live -= int(rows.size)

    # -- query -------------------------------------------------------------

    def _queries(self, queries) -> torch.Tensor:
        q = torch.as_tensor(queries).to(self.device).float()
        if q.dim() == 1:
            q = q[None, :]
        if q.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, q.shape[1])
        return q

    def search(self, queries, k: int, nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        if self._x is None or self.n_rows == 0:
            return _empty_result(queries, k)
        q = self._queries(queries)
        if q.shape[0] >= self.batch_share_threshold:
            return self.search_batch(queries, k, nprobe=nprobe)
        if self.metric == "cosine":
            q = l2_normalize(q)
        np_eff = min(nprobe or self.nprobe, self.nlist)
        return _to_host(*ivf_search(q, self._centroids, self._x, self._ids, self._bias,
                                    k, np_eff))

    def search_batch(self, queries, k: int, nprobe: Optional[int] = None,
                     tile_u: int = 16) -> Tuple[np.ndarray, np.ndarray]:
        """Batch-shared search (`ivf_batch_search`): same results as search()."""
        if self._x is None or self.n_rows == 0:
            return _empty_result(queries, k)
        q = self._queries(queries)
        if self.metric == "cosine":
            q = l2_normalize(q)
        np_eff = min(nprobe or self.nprobe, self.nlist)
        _, probe_ids = coarse_probe(q, self._centroids, np_eff)
        cells_u = union_cells(probe_ids, self.nlist, tile_u)
        return _to_host(*ivf_batch_search(q, probe_ids, cells_u, self._x, self._ids,
                                          self._bias, k, tile_u=tile_u))

    # -- state -------------------------------------------------------------

    def arrays(self):
        return self._centroids, self._x, self._ids, self._bias

    def _adopt(self, centroids, id_lists, bias_lists, fill, list_cap: int, n_rows: int,
               n_live: int) -> None:
        """The state shared by both IVF tiers (see load_arrays)."""
        centroids, ids, bias = _as_tensor(centroids), _as_tensor(id_lists), _as_tensor(bias_lists)
        if centroids.dim() != 2 or centroids.shape[1] != self.dim:
            raise DimensionMismatch(self.dim, centroids.shape[1] if centroids.dim() == 2 else -1)
        self._centroids = centroids.to(device=self.device, dtype=torch.float32).contiguous()
        self._ids = ids.to(device=self.device, dtype=torch.int32).contiguous()
        self._bias = bias.to(device=self.device, dtype=torch.float32).contiguous()
        self.nlist = int(centroids.shape[0])
        self.nprobe = min(self.nprobe, self.nlist)
        self.list_cap = int(list_cap)
        self.n_rows = int(n_rows)
        self.n_live = int(n_live)
        self._fill = np.array(fill, dtype=np.int64)
        # rebuild the row -> (cell, pos) map for future deletes
        ids_np = self._ids.cpu().numpy()
        cells, pos = np.nonzero(ids_np >= 0)
        self._row_loc = np.full((max(self.n_rows, 1), 2), -1, np.int64)
        self._row_loc[ids_np[cells, pos], 0] = cells
        self._row_loc[ids_np[cells, pos], 1] = pos

    def load_arrays(self, centroids, x_lists, id_lists, bias_lists, fill, list_cap: int,
                    n_rows: int, n_live: int) -> None:
        """Adopt a trained, filled index from numpy arrays or tensors (the
        JAX index's arrays(), _fill and counters, or a snapshot): centroids
        [nlist, D], x_lists [nlist, cap, D], id_lists / bias_lists
        [nlist, cap], fill [>= nlist]."""
        self._adopt(centroids, id_lists, bias_lists, fill, list_cap, n_rows, n_live)
        self._x = _as_tensor(x_lists).to(device=self.device, dtype=self.dtype).contiguous()

    def stats(self) -> dict:
        """Cell fill statistics."""
        fill = self._fill
        used = int(fill.sum())
        cap_total = self.nlist * self.list_cap
        return {
            "nlist": self.nlist,
            "list_cap": self.list_cap,
            "rows": self.n_rows,
            "live": self.n_live,
            "max_fill": int(fill.max()) if self.nlist else 0,
            "empty_cells": int((fill == 0).sum()),
            "padding_waste": 1.0 - used / cap_total if cap_total else 0.0,
        }

    def __len__(self) -> int:
        return self.n_live


__all__ = ["IVFIndex", "ivf_search", "ivf_batch_search", "spill_assign", "spill_assign_host"]

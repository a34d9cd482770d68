"""IVF-PQ: coarse k-means cells + residual product-quantized codes.

Port of `codegraph_tpu/index/ivfpq.py`. Each row is stored as m uint8
codes of its residual against its cell centroid, so a 768-d f32 row
(3 KB) becomes m bytes. Scoring uses the dot decomposition

    q . x  =  q . c(x)  +  q . (x - c(x))  ~=  coarse + ADC(residual)

Codes live subspace-major as [nlist, m, cap] uint8 (cap a multiple of
128), the reference's layout, so that snapshots are shared.

* `ivfpq_search` (the counterpart of `ivfpq_search_kernel`) is the plain
  PyTorch version of the scan; `adc_topk` is its part after the coarse
  stage.
* `ivfpq_search_cuda` (K8, the counterpart of `ivfpq_search_pallas`)
  runs the coarse product, top-nprobe and ADC table as PyTorch calls and
  then the hand-written kernel in `csrc/ivfpq_adc.cu` on CUDA tensors,
  over each cell's live extent only. On CPU tensors it runs
  `ivfpq_search`. Nothing falls back.
* `ivfpq_batch_search` (the counterpart of `ivfpq_batch_search_kernel`)
  decodes each unique probed cell once and scores the whole batch.

Routing in `IVFPQIndex.search`: a CUDA index runs K8 for every batch
size (the reference's accelerator route), with its cells' fills as the
extents; a CPU index sends batches of
`batch_share_threshold` (256) or more to `search_batch` and the rest to
`ivfpq_search`, as the reference does on the CPU.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.core.errors import DimensionMismatch
from codegraph_tpu_torch.core.padding import LANE, round_up
from codegraph_tpu_torch.index.flat import _as_tensor
from codegraph_tpu_torch.index.ivf import (
    SEARCH_TILE_B,
    IVFIndex,
    _empty_result,
    _to_host,
    batch_member_tiles,
    coarse_probe,
    union_cells,
)
from codegraph_tpu_torch.ops.kmeans import assign_clusters
from codegraph_tpu_torch.ops.pq import pq_encode
from codegraph_tpu_torch.ops.similarity import l2_normalize
from codegraph_tpu_torch.ops.topk import MERGE_GROUP, NEG_INF, _on_cpu, merge_topk

# ---------------------------------------------------------------------------
# the scan: plain version and K8
# ---------------------------------------------------------------------------


def adc_inputs(q: torch.Tensor, centroids: torch.Tensor, books: torch.Tensor, nprobe: int):
    """(probe_s [B, nprobe] f32, probe_ids [B, nprobe], table [B, m, ksub]
    f32): the coarse stage and the ADC table, computed outside the scan."""
    B = q.shape[0]
    m, _, dsub = books.shape
    probe_s, probe_ids = coarse_probe(q, centroids, nprobe)
    table = torch.einsum("bmd,mkd->bmk", q.reshape(B, m, dsub), books.float())
    return probe_s, probe_ids, table


def adc_topk(table, probe_ids, probe_s, code_lists, id_lists, bias_lists, k: int):
    """Plain scan: per probe step, the ADC of the [B, m, cap] cell codes
    (queries in tiles of SEARCH_TILE_B), + the coarse score + bias, merged
    into the running top-k (the probe order decides a tie)."""
    B, nprobe = probe_ids.shape
    top_s = torch.full((B, k), NEG_INF, dtype=torch.float32, device=table.device)
    top_i = torch.full((B, k), -1, dtype=torch.int32, device=table.device)
    for p in range(nprobe):
        cell = probe_ids[:, p].long()
        adc = torch.cat([
            torch.gather(table[b0: b0 + SEARCH_TILE_B], 2,
                         code_lists[cell[b0: b0 + SEARCH_TILE_B]].long()).sum(dim=1)
            for b0 in range(0, B, SEARCH_TILE_B)])                     # [B, cap]
        s = probe_s[:, p, None] + adc + bias_lists[cell]
        top_s, top_i = merge_topk(top_s, top_i, s, id_lists[cell], k)
    return top_s, top_i


def ivfpq_search(
    q: torch.Tensor,           # [B, D] f32
    centroids: torch.Tensor,   # [nlist, D] f32 coarse
    code_lists: torch.Tensor,  # [nlist, m, cap] uint8 residual codes
    id_lists: torch.Tensor,    # [nlist, cap] i32 (-1 pad)
    bias_lists: torch.Tensor,  # [nlist, cap] f32 (0 live / NEG_INF dead)
    books: torch.Tensor,       # [m, ksub, dsub] f32 residual codebooks
    k: int,
    nprobe: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain ADC search. Returns (approximate scores [B, k], ids [B, k])."""
    probe_s, probe_ids, table = adc_inputs(q, centroids, books, nprobe)
    return adc_topk(table, probe_ids, probe_s, code_lists, id_lists, bias_lists, k)


#: csrc/ivfpq_adc.cu: a block (adc_qmajor) scans steps of 256 threads x 8
#: slots with one list a half-warp (16 a block) and at most two blocks an SM
#: (__launch_bounds__(256, 2)). An H100 has 132 SMs of 228 KB shared memory,
#: 1 KB of it reserved a block; a block may use 227 KB. Pass 2
#: (topk_merge.cuh: 4 warps x 3 lists of k) merges k up to MERGE_MAX_K in
#: shared memory, larger k pairwise in device memory.
ADC_TILE = 2048
ADC_LISTS = 16
ADC_CAP = 32  # candidate buffer entries (topk_merge.cuh kCap)
SM_COUNT = 132
SM_SMEM = 233_472
BLOCK_SMEM_RESERVED = 1024
SMEM_LIMIT = 232_448
QMAJOR_MAX_BLOCKS = 2
MERGE_MAX_K = SMEM_LIMIT // (4 * 3 * 8)


def qmajor_smem(m: int, ksub: int, nprobe: int, table_in_smem: int) -> int:
    """Shared memory (bytes) of a K8 block (`qmajor_smem` in the .cu): the
    staged table, the probes' prefix and cells, 16 candidate
    buffers and list states."""
    return ((m * ksub * 4 if table_in_smem else 0) + (2 * nprobe + 1) * 4
            + ADC_LISTS * ADC_CAP * 8 + ADC_LISTS * 3 * 4)


def blocks_per_sm(smem: int, max_blocks: int) -> int:
    """Blocks of `smem` bytes that an SM holds at once, at most max_blocks."""
    return min(max_blocks, SM_SMEM // (smem + BLOCK_SMEM_RESERVED))


def adc_plan(B: int, nprobe: int, cap: int, k: int, blocks: int = QMAJOR_MAX_BLOCKS) -> int:
    """Splits a query of K8's (query, split) grid: enough blocks for one
    wave at `blocks` an SM, at most one per 2048-slot tile
    of the query's capacity (the kernel divides the live slots among them);
    one split when k is above pass 2's shared memory."""
    if k > MERGE_MAX_K:
        return 1
    n_tiles = -(-nprobe * cap // ADC_TILE)
    return max(1, min(n_tiles, blocks * SM_COUNT // B))


def adc_qmajor_plan(B: int, nprobe: int, m: int, ksub: int, cap: int,
                    k: int) -> Tuple[int, int, int]:
    """(splits, table_in_smem, blocks an SM) of a K8 launch: the table is
    staged when the block still fits; the lists never take shared
    memory, so the blocks an SM are the same at every k."""
    table = int(qmajor_smem(m, ksub, nprobe, 1) <= SMEM_LIMIT)
    blocks = blocks_per_sm(qmajor_smem(m, ksub, nprobe, table), QMAJOR_MAX_BLOCKS)
    return adc_plan(B, nprobe, cap, k, blocks), table, blocks


_lib_handle = None
_count_lock = threading.Lock()


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from codegraph_tpu_torch.ops import cuda_build

        lib = cuda_build.load("ivfpq_adc")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ivfpq_adc_qmajor.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                                         p, p, p, p, p, p]
        lib.ivfpq_adc_qmajor.restype = i
        lib.ivfpq_qmajor_smem.argtypes = [i, i, i, i]
        lib.ivfpq_qmajor_smem.restype = ll
        lib.ivfpq_adc_work_entries.argtypes = [i, i, i, i]
        lib.ivfpq_adc_work_entries.restype = ll
        lib.ivfpq_merge_max_k.argtypes = []
        lib.ivfpq_merge_max_k.restype = i
        _lib_handle = lib
    return _lib_handle


def _check_adc(code_lists, id_lists, bias_lists, books, k: int, extents=None) -> None:
    nlist, m, cap = code_lists.shape
    ksub = books.shape[1]
    if code_lists.dtype != torch.uint8 or id_lists.dtype != torch.int32 \
            or bias_lists.dtype != torch.float32:
        raise ValueError("expected uint8 codes, int32 ids and float32 biases")
    if id_lists.shape != (nlist, cap) or bias_lists.shape != (nlist, cap) or books.shape[0] != m:
        raise ValueError(f"shape mismatch: codes {tuple(code_lists.shape)}, ids "
                         f"{tuple(id_lists.shape)}, bias {tuple(bias_lists.shape)}, "
                         f"books {tuple(books.shape)}")
    if cap % 8 or not 1 <= ksub <= 256 or ksub & (ksub - 1):
        raise ValueError(f"the kernel needs cap % 8 == 0 (got {cap}) and ksub a power of "
                         f"two <= 256 (got {ksub})")
    if not all(t.is_contiguous() for t in (code_lists, id_lists, bias_lists)):
        raise ValueError("codes, ids and biases must be contiguous")
    if any(t.data_ptr() % 16 for t in (code_lists, id_lists, bias_lists)):
        raise ValueError("the kernel reads codes, ids and biases in 8- and 16-byte pieces: "
                         "they must be 16-byte aligned")
    if extents is not None and (extents.dtype != torch.int32 or extents.shape != (nlist,)
                                or not extents.is_contiguous()):
        raise ValueError(f"extents must be a contiguous [nlist={nlist}] int32 tensor, got "
                         f"{extents.dtype} {tuple(extents.shape)}")
    if k < 1:
        raise ValueError(f"k={k} must be positive")


def ivfpq_search_cuda(
    q: torch.Tensor, centroids: torch.Tensor, code_lists: torch.Tensor,
    id_lists: torch.Tensor, bias_lists: torch.Tensor, books: torch.Tensor,
    k: int, nprobe: int, extents: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: the ADC scan of `ivfpq_search` as a CUDA kernel, exact top-k
    for any k. extents [nlist] i32: the live slots of each cell, a prefix
    (its fill; cap when not given): the kernel scans no slot past it, and
    every such slot is padding, so the result is the same. CPU tensors run
    `ivfpq_search`, which scans every slot and takes no extents."""
    tensors = (q, centroids, code_lists, id_lists, bias_lists, books)
    if extents is not None:
        tensors += (extents,)
    if _on_cpu(*tensors):
        return ivfpq_search(q, centroids, code_lists, id_lists, bias_lists, books, k, nprobe)
    _check_adc(code_lists, id_lists, bias_lists, books, k, extents)
    lib = _lib()
    B = q.shape[0]
    nlist, m, cap = code_lists.shape
    ksub = books.shape[1]
    probe_s, probe_ids, table = adc_inputs(q.float(), centroids, books, nprobe)
    probe_s = probe_s.contiguous()
    table = table.contiguous()
    if extents is None:
        extents = torch.full((nlist,), cap, dtype=torch.int32, device=q.device)
    out_s = torch.empty((B, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=q.device)
    bound = torch.empty((B,), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    probe_ids = probe_ids.to(torch.int32).contiguous()
    splits, t_smem, _ = adc_qmajor_plan(B, nprobe, m, ksub, cap, k)
    n_work = max(1, lib.ivfpq_adc_work_entries(B, k, splits * ADC_LISTS, MERGE_GROUP))
    work_s = torch.empty((n_work,), dtype=torch.float32, device=q.device)
    work_i = torch.empty((n_work,), dtype=torch.int32, device=q.device)
    err = lib.ivfpq_adc_qmajor(
        table.data_ptr(), probe_ids.data_ptr(), probe_s.data_ptr(), code_lists.data_ptr(),
        id_lists.data_ptr(), bias_lists.data_ptr(), extents.data_ptr(), B, nprobe, m, ksub,
        cap, k, splits, t_smem, MERGE_GROUP, out_s.data_ptr(), out_i.data_ptr(),
        work_s.data_ptr(), work_i.data_ptr(), bound.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"ivfpq_adc kernel launch failed: CUDA error {err} (B={B}, "
                           f"nprobe={nprobe}, m={m}, ksub={ksub}, cap={cap}, k={k})")
    with _count_lock:
        ivfpq_search_cuda.launches += 1
    return out_s, out_i


ivfpq_search_cuda.launches = 0


def ivfpq_batch_search(
    q: torch.Tensor,           # [B, D] f32
    probe_ids: torch.Tensor,   # [B, nprobe] cells each query probes
    cells_u: torch.Tensor,     # [U_pad] union of probed cells (pad = nlist)
    code_lists: torch.Tensor,  # [nlist, m, cap] uint8
    id_lists: torch.Tensor,    # [nlist, cap] i32
    bias_lists: torch.Tensor,  # [nlist, cap] f32
    centroids: torch.Tensor,   # [nlist, D] f32
    books: torch.Tensor,       # [m, ksub, dsub] f32
    k: int,
    tile_u: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-shared IVF-PQ search: decode each unique probed cell once
    (codes -> codebook rows + centroid) and score it against the whole
    batch with one product; a membership mask re-imposes each query's own
    nprobe cells."""
    B, D = q.shape
    m = books.shape[0]
    nlist, cap = id_lists.shape
    sub = torch.arange(m, device=q.device)
    top_s = torch.full((B, k), NEG_INF, dtype=torch.float32, device=q.device)
    top_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for cu, mem in batch_member_tiles(probe_ids, cells_u, tile_u):
        cu_safe = torch.clamp(cu, max=nlist - 1).long()
        codes = code_lists[cu_safe].transpose(1, 2).long()          # [tu, cap, m]
        rec = books.float()[sub, codes]                              # [tu, cap, m, dsub]
        dec = rec.reshape(cu.shape[0], cap, D) + centroids[cu_safe][:, None, :]
        s = torch.einsum("bd,ucd->buc", q, dec) + bias_lists[cu_safe][None, :, :]
        s = s + torch.where(mem, 0.0, NEG_INF)[:, :, None]
        ids = id_lists[cu_safe].reshape(1, -1).expand(B, -1)
        top_s, top_i = merge_topk(top_s, top_i, s.reshape(B, -1), ids, k)
    return top_s, top_i


# ---------------------------------------------------------------------------
# filters and the refine stage
# ---------------------------------------------------------------------------


def _host_bias(extra_bias) -> np.ndarray:
    if torch.is_tensor(extra_bias):
        return extra_bias.detach().cpu().numpy().astype(np.float32)
    return np.asarray(extra_bias, np.float32)


def _filter_fetch_k(k: int, extra_bias, cap_total: int) -> int:
    """Candidates for a filtered approximate search: the over-fetch scales
    with the filter's selectivity (a 2% filter fetches ~50x), bounded by
    the probed capacity."""
    eb = _host_bias(extra_bias)
    allowed = float(np.mean(eb > float(NEG_INF) / 2)) if eb.size else 1.0
    mult = min(64.0, 2.0 / max(allowed, 1.0 / 64.0))
    return int(min(cap_total, max(4 * k, round(k * mult))))


def _apply_extra_bias_post(s_np, i_np, extra_bias):
    """Drop candidates the filter mask excludes (post-scan, host)."""
    eb = _host_bias(extra_bias)
    safe = np.minimum(np.maximum(i_np, 0), eb.shape[0] - 1)
    excl = (i_np >= 0) & (i_np < eb.shape[0]) & (eb[safe] <= float(NEG_INF) / 2)
    return np.where(excl, float(NEG_INF), s_np), np.where(excl, -1, i_np)


def _truncate_topk(s_np, i_np, k: int):
    order = np.argsort(-s_np, axis=1)[:, :k]
    return np.take_along_axis(s_np, order, axis=1), np.take_along_axis(i_np, order, axis=1)


def _quantize_rows_device(v: torch.Tensor):
    """Per-row symmetric int8 on the index's device: (int8 [n, D], f32
    scales [n, 1])."""
    scale = torch.clamp(v.abs().amax(dim=1, keepdim=True), min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q8, scale.float()


def _bank_write(bank, scales, q8, sc, off: int) -> None:
    """Write a row block into the preallocated refine bank at row `off`,
    in place (no second bank is ever allocated)."""
    bank[off: off + q8.shape[0]] = q8
    scales[off: off + sc.shape[0]] = sc


def _refine_rows(q, raw, scales, ids):
    """Exact scores of candidate rows: int8 rows gathered by id, f32 dot,
    times the row's scale; NEG_INF where the id is -1."""
    safe = torch.clamp(ids, min=0).long()
    rows = raw[safe].float()                                   # [B, R, D]
    ex = torch.einsum("bd,brd->br", q, rows) * scales[:, 0][safe]
    return torch.where(ids >= 0, ex, NEG_INF)


def _refine_device_kernel(q, raw, scales, s_cand, i_cand, k: int):
    """Exact on-device rescore of the PQ candidates, re-top-k."""
    s_top, pos = torch.topk(_refine_rows(q, raw, scales, i_cand), k, dim=1)
    return s_top, torch.gather(i_cand, 1, pos)


def _refine_device_tiled(q, raw, scales, s_cand, i_cand, k: int, tile_c: int = 128):
    """_refine_device_kernel with the candidate axis in tiles of tile_c:
    the f32 gather peaks at [B, tile_c, D] instead of [B, R, D]."""
    exact = torch.cat([_refine_rows(q, raw, scales, i_cand[:, c0: c0 + tile_c])
                       for c0 in range(0, i_cand.shape[1], tile_c)], dim=1)
    s_top, pos = torch.topk(exact, k, dim=1)
    return s_top, torch.gather(i_cand, 1, pos)


class IVFPQIndex(IVFIndex):
    """IVF cells storing m-byte residual PQ codes instead of vectors.

    refine: "none"; "int8" or "f32" keep the rows in host memory and
    rescore the top refine_factor * k candidates exactly; "int8_device"
    keeps int8 rows + scales in a bank on the index's device. opq=True
    learns an orthogonal rotation (ops/opq.py) applied to every vector,
    query and centroid. device: "cuda" (default) or "cpu".
    """

    def __init__(
        self,
        dim: int,
        nlist: int = 4096,
        nprobe: int = 64,
        m: int = 96,
        nbits: int = 8,
        metric: str = "cosine",
        kmeans_iters: int = 10,
        pq_iters: int = 10,
        capacity_factor: float = 2.0,
        train_sample: int = 262_144,
        refine: str = "none",
        refine_factor: int = 4,
        opq: bool = False,
        opq_iters: int = 6,
        pq_train_sample: Optional[int] = None,
        seed: int = 0,
        device="cuda",
    ):
        if dim % m != 0:
            raise ValueError(f"dim={dim} not divisible by m={m}")
        if refine not in ("none", "int8", "f32", "int8_device"):
            raise ValueError(f"unknown refine mode {refine!r}")
        super().__init__(
            dim, nlist=nlist, nprobe=nprobe, metric=metric, dtype="float32",
            kmeans_iters=kmeans_iters, capacity_factor=capacity_factor,
            train_sample=train_sample, seed=seed, device=device,
        )
        self.m = int(m)
        self.nbits = int(nbits)
        self.pq_iters = int(pq_iters)
        self.refine = refine
        self.refine_factor = int(refine_factor)
        self.opq = bool(opq)
        self.opq_iters = int(opq_iters)
        self.pq_train_sample = int(pq_train_sample) if pq_train_sample else None
        self._rot: Optional[torch.Tensor] = None    # [D, D]; x_rot = x @ rot
        # on a CPU index, batches at least this large take search_batch
        self.batch_share_threshold = 256
        self._books: Optional[torch.Tensor] = None  # [m, ksub, dsub]
        self._raw_chunks: list = []                 # host int8/f32 rows (refine)
        self._raw_scales: list = []                 # host f32 per-row scales
        self._dev_chunks: list = []                 # device int8 rows (refine)
        self._dev_scales: list = []                 # device f32 scales [n, 1]
        # True once _dev_reserve preallocated the bank: adds then write in
        # place at offset n_rows
        self._dev_prealloc = False
        self._ext: Optional[torch.Tensor] = None  # K8's extents; None: stale

    # -- build -------------------------------------------------------------

    def reserve(self, n_rows: int) -> None:
        """Preallocate the cells and, for refine="int8_device", the
        [n_rows, D] int8 bank + scales."""
        super().reserve(n_rows)
        if self.refine == "int8_device":
            self._dev_reserve(n_rows)

    def _dev_reserve(self, cap_rows: int) -> None:
        have_bank, have_scales = self._dev_bank() if self._dev_chunks else (None, None)
        have = 0 if have_bank is None else int(have_bank.shape[0])
        if self._dev_prealloc and have >= int(cap_rows):
            return
        rows = max(int(cap_rows), have, 1)
        bank = torch.zeros((rows, self.dim), dtype=torch.int8, device=self.device)
        scales = torch.ones((rows, 1), dtype=torch.float32, device=self.device)
        if have:
            _bank_write(bank, scales, have_bank, have_scales, 0)
        self._dev_chunks = [bank]
        self._dev_scales = [scales]
        self._dev_prealloc = True

    def _prepare(self, vectors) -> torch.Tensor:
        v = super()._prepare(vectors)
        return v if self._rot is None else v @ self._rot

    def train(self, vectors) -> None:
        """Coarse k-means (inherited), then residual PQ codebooks (or OPQ)
        on a sample of the same vectors."""
        self._rot = None
        super().train(vectors)
        v = self._sample(self._prepare(vectors),
                         min(self.train_sample, self.pq_train_sample or self.train_sample))
        tile = min(4096, round_up(v.shape[0], 8))
        assign = assign_clusters(v, self._centroids, None, tile_n=tile,
                                 metric="cosine" if self.metric == "cosine" else "dot")
        residuals = v - self._centroids[assign.long()]
        nbits_eff = self.nbits  # tiny corpora: shrink codebooks so ksub <= train rows
        while (1 << nbits_eff) > v.shape[0] and nbits_eff > 1:
            nbits_eff -= 1
        if self.opq:
            from codegraph_tpu_torch.ops.opq import opq_train

            rot, books = opq_train(residuals, self.m, nbits=nbits_eff, n_iters=self.opq_iters,
                                   pq_iters=2, final_pq_iters=self.pq_iters, seed=self.seed)
            self._books = books.centroids
            self._centroids = self._centroids @ rot
            self._rot = rot
        else:
            from codegraph_tpu_torch.ops.opq import pq_train_batched

            self._books = pq_train_batched(residuals, self.m, nbits=nbits_eff,
                                           n_iters=self.pq_iters, seed=self.seed).centroids

    @property
    def is_trained(self) -> bool:
        return self._centroids is not None and self._books is not None

    def _cell_cap(self, list_cap: int) -> int:
        return max(LANE, round_up(list_cap, LANE))

    def _new_cells(self, list_cap: int) -> torch.Tensor:
        return torch.zeros((self.nlist, self.m, list_cap), dtype=torch.uint8, device=self.device)

    def _copy_cells(self, new: torch.Tensor, old: int) -> None:
        new[:, :, :old] = self._x[:, :, :old]

    def _store_values(self, v: torch.Tensor, cells: torch.Tensor) -> torch.Tensor:
        """Bank the rows for the refine stage, then residual-encode them
        against their cells -> [n, m] uint8 codes."""
        if self.refine == "int8":
            vn = v.cpu().numpy()
            scale = np.maximum(np.max(np.abs(vn), axis=1, keepdims=True), 1e-12) / 127.0
            self._raw_chunks.append(np.clip(np.round(vn / scale), -127, 127).astype(np.int8))
            self._raw_scales.append(scale.astype(np.float32))
        elif self.refine == "int8_device":
            q8, sc = _quantize_rows_device(v)
            if self._dev_prealloc:
                need = self.n_rows + int(q8.shape[0])
                if need > int(self._dev_chunks[0].shape[0]):
                    self._dev_reserve(max(need, int(self._dev_chunks[0].shape[0] * 1.5)))
                _bank_write(self._dev_chunks[0], self._dev_scales[0], q8, sc, self.n_rows)
            else:
                self._dev_chunks.append(q8)
                self._dev_scales.append(sc)
        elif self.refine == "f32":
            vn = v.cpu().numpy().astype(np.float32)
            self._raw_chunks.append(vn)
            self._raw_scales.append(np.ones((vn.shape[0], 1), np.float32))
        return pq_encode(v - self._centroids[cells], self._books)

    def _scatter_payload(self, cells, pos, vals) -> None:
        """vals [n, m] codes into [nlist, m, cap] at (cell, :, pos)."""
        self._x[cells, :, pos] = vals

    def add(self, vectors) -> np.ndarray:
        rows = super().add(vectors)
        self._ext = None
        return rows

    def _extents(self) -> torch.Tensor:
        """[nlist] int32 on the index's device: the live slots of each cell,
        a prefix (its fill, clipped to list_cap; `_fill` may be longer than
        nlist, see index/ivf.py). Every slot at or past it holds id -1 and
        bias NEG_INF. Made again after add and load_arrays."""
        if self._ext is None:
            fill = np.minimum(self._fill[: self.nlist], self.list_cap).astype(np.int32)
            self._ext = torch.as_tensor(fill, device=self.device)
        return self._ext

    # -- query -------------------------------------------------------------

    def _maybe_rotate(self, q: torch.Tensor) -> torch.Tensor:
        return q if self._rot is None else q @ self._rot

    def _fetch_k(self, k: int, np_eff: int, extra_bias) -> Tuple[int, bool]:
        use_refine = self.refine != "none" and bool(self._raw_chunks or self._dev_chunks)
        k_fetch = max(k, min(k * self.refine_factor, self.list_cap * np_eff)) if use_refine else k
        if extra_bias is not None:
            k_fetch = max(k_fetch, _filter_fetch_k(k, extra_bias, self.list_cap * np_eff))
        return k_fetch, use_refine

    def search(self, queries, k: int, nprobe: Optional[int] = None,
               extra_bias=None) -> Tuple[np.ndarray, np.ndarray]:
        """extra_bias: optional [n] f32 filter mask by global row id (0
        allowed, NEG_INF excluded), applied after the scan over an
        over-fetch that scales with the filter's selectivity."""
        if self._x is None or self.n_rows == 0:
            return _empty_result(queries, k)
        q = self._queries(queries)
        on_card = self.device.type == "cuda"
        if q.shape[0] >= self.batch_share_threshold and not on_card:
            return self.search_batch(queries, k, nprobe=nprobe, extra_bias=extra_bias)
        if self.metric == "cosine":
            q = l2_normalize(q)
        q = self._maybe_rotate(q)
        np_eff = min(nprobe or self.nprobe, self.nlist)
        k_fetch, use_refine = self._fetch_k(k, np_eff, extra_bias)
        state = (q, self._centroids, self._x, self._ids, self._bias, self._books, k_fetch,
                 np_eff)
        if on_card:
            s, i = ivfpq_search_cuda(*state, extents=self._extents())
        else:
            s, i = ivfpq_search(*state)
        return self._finish(q, s, i, k, k_fetch, use_refine, extra_bias)

    def search_batch(self, queries, k: int, nprobe: Optional[int] = None, tile_u: int = 16,
                     extra_bias=None) -> Tuple[np.ndarray, np.ndarray]:
        """Batch-shared search (`ivfpq_batch_search`): same scores as
        search() up to rounding (decoded rows instead of table sums)."""
        if self._x is None or self.n_rows == 0:
            return _empty_result(queries, k)
        q = self._queries(queries)
        if self.metric == "cosine":
            q = l2_normalize(q)
        q = self._maybe_rotate(q)
        np_eff = min(nprobe or self.nprobe, self.nlist)
        _, probe_ids = coarse_probe(q, self._centroids, np_eff)
        cells_u = union_cells(probe_ids, self.nlist, tile_u)
        k_fetch, use_refine = self._fetch_k(k, np_eff, extra_bias)
        s, i = ivfpq_batch_search(q, probe_ids, cells_u, self._x, self._ids, self._bias,
                                  self._centroids, self._books, k_fetch, tile_u=tile_u)
        return self._finish(q, s, i, k, k_fetch, use_refine, extra_bias)

    def _finish(self, q, s, i, k: int, k_fetch: int, use_refine: bool, extra_bias):
        """Filter, refine and truncate the scan's k_fetch candidates."""
        if use_refine and self.refine == "int8_device" and extra_bias is None:
            # candidates stay on the device until after the exact rescore
            return _to_host(*self._refine_dev(q, s, i, k))
        s_np, i_np = _to_host(s, i)
        if extra_bias is not None:
            s_np, i_np = _apply_extra_bias_post(s_np, i_np, extra_bias)
        if not use_refine:
            if k_fetch > k:
                s_np, i_np = _truncate_topk(s_np, i_np, k)
            return s_np, i_np
        if self.refine == "int8_device":
            return _to_host(*self._refine_dev(
                q, torch.as_tensor(s_np, device=self.device),
                torch.as_tensor(i_np, device=self.device), k))
        return self._refine_host(q.cpu().numpy(), s_np, i_np, k)

    def _refine_dev(self, q, s_cand, i_cand, k: int):
        """Flat rescore up to 256 candidates per query, tiled above."""
        raw, scales = self._dev_bank()
        if int(i_cand.shape[1]) > 256:
            return _refine_device_tiled(q, raw, scales, s_cand, i_cand, k)
        return _refine_device_kernel(q, raw, scales, s_cand, i_cand, k)

    def _dev_bank(self):
        """The device refine bank as one [N, D] tensor (append-mode chunks
        are concatenated once)."""
        if len(self._dev_chunks) > 1:
            self._dev_chunks = [torch.cat(self._dev_chunks)]
            self._dev_scales = [torch.cat(self._dev_scales)]
        return self._dev_chunks[0], self._dev_scales[0]

    def _refine_host(self, qnp: np.ndarray, s_np: np.ndarray, i_np: np.ndarray,
                     k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact host rescore of the candidate set (rows * scales)."""
        if len(self._raw_chunks) > 1:
            self._raw_chunks = [np.concatenate(self._raw_chunks)]
            self._raw_scales = [np.concatenate(self._raw_scales)]
        raw, scales = self._raw_chunks[0], self._raw_scales[0]
        safe = np.maximum(i_np, 0)
        vecs = raw[safe].astype(np.float32) * scales[safe]  # [B, R, D]
        exact = np.einsum("bd,brd->br", qnp, vecs)
        exact = np.where(i_np >= 0, exact, float(NEG_INF))
        order = np.argsort(-exact, axis=1)[:, :k]
        return (np.take_along_axis(exact, order, axis=1),
                np.take_along_axis(i_np, order, axis=1))

    # -- state -------------------------------------------------------------

    def load_arrays(self, centroids, code_lists, id_lists, bias_lists, fill, list_cap: int,
                    n_rows: int, n_live: int, books=None, rot=None, refine_rows=None,
                    refine_scales=None) -> None:
        """Adopt a trained, filled index from numpy arrays or tensors (the
        JAX index's state, or a snapshot): code_lists [nlist, m, cap] uint8
        subspace-major, books [m, ksub, dsub], rot [D, D] or None (OPQ), and
        the refine rows [n, D] + scales [n, 1] or None. The rows go to the
        host store for refine "int8"/"f32" and to the device bank for
        "int8_device"."""
        self._adopt(centroids, id_lists, bias_lists, fill, list_cap, n_rows, n_live)
        self._ext = None
        codes = _as_tensor(code_lists)
        if codes.dim() != 3 or codes.shape[1] != self.m:
            raise ValueError(f"codes {tuple(codes.shape)} are not [nlist, m={self.m}, cap]")
        self._x = codes.to(device=self.device, dtype=torch.uint8).contiguous()
        self._books = _as_tensor(books).to(device=self.device, dtype=torch.float32).contiguous()
        self._rot = (None if rot is None else
                     _as_tensor(rot).to(device=self.device, dtype=torch.float32).contiguous())
        self._raw_chunks, self._raw_scales = [], []
        self._dev_chunks, self._dev_scales = [], []
        self._dev_prealloc = False
        if refine_rows is None:
            return
        if self.refine == "int8_device":
            self._dev_chunks = [_as_tensor(refine_rows).to(self.device, torch.int8)]
            self._dev_scales = [_as_tensor(refine_scales).to(self.device, torch.float32)]
        else:
            self._raw_chunks = [np.asarray(refine_rows)]
            self._raw_scales = [np.asarray(refine_scales, np.float32)]

    def stats(self) -> dict:
        st = super().stats()
        st.update({
            "m": self.m,
            "nbits": self.nbits,
            "opq": self._rot is not None,
            "bytes_per_row": self.m + 4 + 4,  # codes + id + bias (device)
            "refine": self.refine,
            "host_bytes_per_row": {"none": 0, "int8": self.dim + 4, "f32": self.dim * 4,
                                   "int8_device": 0}[self.refine],
            "hbm_refine_bytes_per_row": self.dim + 4 if self.refine == "int8_device" else 0,
        })
        return st


__all__ = [
    "IVFPQIndex",
    "adc_topk",
    "ivfpq_search",
    "ivfpq_search_cuda",
    "ivfpq_batch_search",
]

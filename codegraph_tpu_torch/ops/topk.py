"""Exact streaming top-k over a device-resident embedding matrix.

Port of `codegraph_tpu/ops/topk.py` (K1 `streaming_topk_pallas`, K2
`streaming_topk_pallas_qmajor`, K3 `streaming_topk_pallas_qres` and K4
`streaming_topk_pallas_qmajor_xt`). Scores are `q @ x.T + bias` in f32 (a
bf16 corpus is widened to f32), and each query row keeps its k best rows,
sorted descending.

* `exact_topk`, `merge_topk`, `streaming_topk` are the plain PyTorch
  versions: a matmul per row tile, then a merge by a stable sort of the
  running top-k and the tile. `streaming_topk` is what the kernels are
  held to; `exact_topk` is its small-N oracle.
* `streaming_topk_cuda` (K1, small batches), `streaming_topk_cuda_qmajor`
  (K2, large batches), `streaming_topk_cuda_qres` (K3, the batch sharing
  each corpus read: K2's schedule) and `streaming_topk_cuda_qmajor_xt`
  (K4, K2 over a pre-transposed corpus xt [D, N]; no index calls K3 or
  K4) launch the
  hand-written kernels in `csrc/flat_topk.cu` on CUDA tensors, and run
  `streaming_topk` on CPU tensors. On a CUDA tensor they launch or raise;
  nothing falls back. `row_plan` is the host-side plan of K2-K4.
* Over bf16 rows K1, K2 and K3 run on the tensor cores instead, for bf16
  and f32 queries alike (`uses_tensor_cores`, a route set by the inputs):
  K1 as `streaming_topk_cuda_k1tc` ("K1tc": `wgmma` with the corpus as the
  64-row operand, `csrc/flat_topk_k1tc.cu`, planned by `k1tc_plan`), K2
  and K3 as `streaming_topk_cuda_tc` over bf16 queries ("K2tc": `wgmma`
  bf16 fed by TMA in `csrc/flat_topk_tc.cu`, planned by `tc_plan`) and as
  `streaming_topk_cuda_tc3` over f32 queries ("K2tc3": the same kernel
  with the query in three bf16 pieces, `ops/bf16_split.py`), each counted
  in its own launches.

Order and sentinels, shared by every version: a higher score wins; on
equal scores the lower row id wins. The running top-k starts as
(NEG_INF, -1), so rows scoring NEG_INF or lower (tombstones) never enter
and rows past the live count come out as (NEG_INF, -1).
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from codegraph_tpu_torch.ops.bf16_split import split_bf16

NEG_INF = -1e30

DEFAULT_TILE_N = 1024
MAX_K = 1024

#: pass-1 layouts of csrc/flat_topk.cu: K1 = column warps (the 8 warps
#: share up to 8 query rows and split a 256-row corpus tile); K2, K3, K4 =
#: row tiles (`rows_pass1`: 128 query rows x 128 corpus rows per block for
#: every k, each thread an 8 x 8 micro tile, or 32 or 64 query rows when
#: the batch fits them; K3 runs K2's schedule; K4 reads the corpus from xt
#: [D, N]). csrc/int8_topk.cu numbers
#: K5/K6/K7 like K1/K2/K3, with the same corpus tiles and query tiles of tm
#: or 8 * tm rows (`row_warps_tm`).
K1_LAYOUT, K2_LAYOUT, K3_LAYOUT, K4_LAYOUT = 0, 1, 2, 3
CORPUS_TILE = {K1_LAYOUT: 256, K2_LAYOUT: 128, K3_LAYOUT: 128, K4_LAYOUT: 128}
#: pass 1 aims at this many blocks per kernel (4 or 2 per SM of an H100);
#: pass 2 merges MERGE_GROUP per-split lists per warp and level
TARGET_BLOCKS = {K1_LAYOUT: 4 * 132, K2_LAYOUT: 2 * 132, K3_LAYOUT: 2 * 132,
                 K4_LAYOUT: 2 * 132}
MERGE_GROUP = 16

#: the row-tile schedule of K2/K3/K4 (csrc/flat_topk.cu `rows_pass1`, whose
#: `RowLayout` these mirror): the query tiles (a small one for a batch
#: that fits it), the corpus tile, the depth of one ring slice, the ring's
#: slices, the candidate buffer entries per query row, and the shared
#: memory one block may have on an H100
ROW_QUERY_TILE = 128
ROW_SMALL_QUERY_TILES = (32, 64)
ROW_CORPUS_TILE = 128
ROW_DEPTH = 16
ROW_STAGES = 3
ROW_CAP = 32
SMEM_PER_BLOCK = 232_448

#: The tensor-core scan kernels, K2tc (K2/K3 over bf16 queries and bf16
#: rows, csrc/flat_topk_tc.cu `bf16_tc_pass1`) and K6/K7 (int8,
#: csrc/int8_topk.cu `int8_tc_pass1`), share one block design, whose
#: `TcLayoutOf` (csrc/hopper_tc.cuh) `tc_smem` mirrors: a consumer
#: warpgroup's product is TC_WG_ROWS query rows x TC_TILE_N corpus rows; a
#: ring stage is a corpus box of TC_TILE_N rows x TC_BOX_BYTES (the swizzle
#: span) of depth; a batch of at most TC_WG_ROWS takes a 64-row query tile
#: (one consumer), larger batches 128-row tiles (two); the query tile stays
#: resident with the most of TC_STAGES ring stages that fit a block's
#: shared memory, or streams with the corpus through the most that fit; at
#: most one block per SM (TC_SMS on an H100) and one wave, so that every
#: corpus split of a query row runs at once and publishes its part of the
#: shared bound from the start. A tile's bias (and int8 corpus scales)
#: come through TC_META_SLOTS slots of their own. Each of a block's
#: TC_SLOTS rows has a candidate buffer of TC_BUF_CAP entries in device
#: memory (room for one tile beyond ROW_CAP), staged through TC_HALF_WARPS
#: areas of shared memory when it is flushed
TC_WG_ROWS = 64
TC_TILE_N = 128
TC_BOX_BYTES = 128
TC_STAGES = (6, 5, 4, 3)
TC_SMS = 132
TC_META_SLOTS = 4
TC_SLOTS = 2 * TC_WG_ROWS
TC_BUF_CAP = ROW_CAP + TC_TILE_N
TC_HALF_WARPS = 16

#: K1tc (K1 over bf16 rows, csrc/flat_topk_k1tc.cu `bf16_k1_pass1`, whose
#: `K1Layout` `k1tc_smem` mirrors): a query tile of the batch rounded up to
#: 8 rows, at most the largest of K1TC_QUERY_TILES (the columns of its
#: `wgmma`); a ring stage is a corpus box of TC_TILE_N rows x TC_BOX_BYTES
#: of depth (64 rows for each of the two consumer warpgroups), with the
#: query tile's boxes beside it when the tile streams; the query tile stays
#: resident with the most of K1TC_STAGES ring stages that fit, else it
#: streams through the most that fit; each query of the tile has a
#: candidate buffer of TC_BUF_CAP entries in shared memory; one block per
#: SM and one wave
K1TC_QUERY_TILES = (8, 16, 24, 32)
K1TC_STAGES = (8, 6, 4, 3)

#: the bf16 pieces of a query of each dtype on the tensor cores: a bf16
#: query as it is, an f32 query as `split_bf16`'s hi + mid + lo
QUERY_PIECES = {torch.bfloat16: 1, torch.float32: 3}


def _sort_desc(s: torch.Tensor, i: torch.Tensor, k: int):
    """Top-k of (s, i) per row under the shared order. The inputs are laid
    out with ids ascending among equal scores, so a stable descending sort
    keeps the lower id first on a tie."""
    top_s, pos = torch.sort(s, dim=-1, descending=True, stable=True)
    return top_s[:, :k], torch.gather(i, -1, pos[:, :k])


def exact_topk(
    q: torch.Tensor, x: torch.Tensor, k: int, bias: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full [B, N] scores, then top-k. Oracle / small-N path (k <= N)."""
    scores = q.float() @ x.float().T
    if bias is not None:
        scores = scores + bias[None, :]
    ids = torch.arange(x.shape[0], dtype=torch.int32, device=scores.device)
    return _sort_desc(scores, ids.expand_as(scores), k)


def merge_topk(
    s_a: torch.Tensor, i_a: torch.Tensor, s_b: torch.Tensor, i_b: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two (scores, ids) candidate sets per row into top-k; on equal
    scores a's entries come first."""
    return _sort_desc(torch.cat([s_a, s_b], dim=-1), torch.cat([i_a, i_b], dim=-1), k)


def streaming_topk(
    q: torch.Tensor,
    x: torch.Tensor,
    bias: torch.Tensor,
    k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain streaming top-k: loop over row tiles of x, carrying the
    running top-k (the XLA `streaming_topk` of the JAX package).

    q [B, D], x [N, D] (any N), bias [N] f32. Returns (scores [B, k] f32,
    ids [B, k] int32) with ids global row indices.
    """
    B = q.shape[0]
    qf = q.float()
    top_s = torch.full((B, k), NEG_INF, dtype=torch.float32, device=q.device)
    top_i = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    for base in range(0, x.shape[0], tile_n):
        xt = x[base: base + tile_n].float()
        s = qf @ xt.T + bias[base: base + tile_n][None, :].float()
        ids = torch.arange(base, base + xt.shape[0], dtype=torch.int32,
                           device=q.device).expand(B, -1)
        top_s, top_i = merge_topk(top_s, top_i, s, ids, k)
    return top_s, top_i


# ---------------------------------------------------------------------------
# K1 / K2 / K3 / K4: hand-written CUDA kernels (csrc/flat_topk.cu)
# ---------------------------------------------------------------------------

_lib_handle = None
_tc_lib_handle = None
_k1tc_lib_handle = None
_count_lock = threading.Lock()


def _k1tc_lib():
    global _k1tc_lib_handle
    if _k1tc_lib_handle is None:
        from codegraph_tpu_torch.ops import cuda_build

        lib = cuda_build.load("flat_topk_k1tc")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flat_topk_k1tc.argtypes = [p, i, p, p, i, i, i, i, i, i, i, i, i, ll, i,
                                       p, p, p, p, p, p]
        lib.flat_topk_k1tc.restype = i
        lib.flat_topk_k1tc_smem.argtypes = [i, i, i, i, i]
        lib.flat_topk_k1tc_smem.restype = ll
        lib.flat_topk_k1tc_work_entries.argtypes = [i, i, i, i]
        lib.flat_topk_k1tc_work_entries.restype = ll
        _k1tc_lib_handle = lib
    return _k1tc_lib_handle


def _tc_lib():
    global _tc_lib_handle
    if _tc_lib_handle is None:
        from codegraph_tpu_torch.ops import cuda_build

        lib = cuda_build.load("flat_topk_tc")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flat_topk_tc.argtypes = [p, i, p, p, i, i, i, i, i, i, i, i, i, ll, i,
                                     p, p, p, p, p, p, p, p]
        lib.flat_topk_tc.restype = i
        lib.flat_topk_tc_smem.argtypes = [i, i, i, i, i]
        lib.flat_topk_tc_smem.restype = ll
        lib.flat_topk_tc_work_entries.argtypes = [i, i, i, i]
        lib.flat_topk_tc_work_entries.restype = ll
        lib.flat_topk_tc_cand_entries.argtypes = [i, i, i]
        lib.flat_topk_tc_cand_entries.restype = ll
        _tc_lib_handle = lib
    return _tc_lib_handle


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from codegraph_tpu_torch.ops import cuda_build

        lib = cuda_build.load("flat_topk")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flat_topk.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p, p, p, p, p]
        lib.flat_topk.restype = i
        lib.flat_topk_rows.argtypes = [p, i, p, i, p, i, i, i, i, i, i, i, i, i, i, ll, i,
                                       p, p, p, p, p, p]
        lib.flat_topk_rows.restype = i
        lib.flat_topk_rows_smem.argtypes = [i, i, i]
        lib.flat_topk_rows_smem.restype = ll
        lib.flat_topk_work_entries.argtypes = [i, i, i, i]
        lib.flat_topk_work_entries.restype = ll
        _lib_handle = lib
    return _lib_handle


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return True
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"q, x and bias must share one CPU or CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    return False


def _check(q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int) -> None:
    if q.dim() != 2 or x.dim() != 2 or bias.dim() != 1:
        raise ValueError("expected q [B, D], x [N, D], bias [N]")
    if q.shape[1] != x.shape[1] or bias.shape[0] != x.shape[0]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, x {tuple(x.shape)}, "
                         f"bias {tuple(bias.shape)}")
    if q.shape[0] < 1 or x.shape[0] < 1:
        raise ValueError("empty query batch or corpus")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {bias.dtype}")
    if not (q.is_contiguous() and x.is_contiguous() and bias.is_contiguous()):
        raise ValueError("q, x and bias must be contiguous")
    if x.shape[1] % 8 or x.data_ptr() % 16:
        raise ValueError(f"the kernel reads rows in 16-byte pieces: D={x.shape[1]} must be a "
                         "multiple of 8 and x 16-byte aligned")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    if x.shape[0] >= 2**31 - 1024 or x.numel() >= 2**62:
        raise ValueError("corpus too large for 32-bit row ids")


def _plan(B: int, N: int, layout: int, tile_b: int) -> Tuple[int, int]:
    """(splits, rows_per_split): enough (query tile x split) blocks to
    fill the card, each split a whole number of corpus tiles."""
    tile_n = CORPUS_TILE[layout]
    n_tiles = -(-N // tile_n)
    b_tiles = -(-B // tile_b)
    splits = max(1, min(n_tiles, -(-TARGET_BLOCKS[layout] // b_tiles)))
    rows = -(-n_tiles // splits) * tile_n
    return -(-N // rows), rows


def work_entries(B: int, k: int, splits: int, group: int = MERGE_GROUP) -> int:
    """Scratch entries (per scores and per ids) of a scan over `splits`
    corpus splits: the per-split lists [B, splits, k] and the first merge
    level (csrc/topk_merge.cuh `merge_work_entries`)."""
    return 0 if splits <= 1 else B * k * (splits + -(-splits // group))


def row_smem(layout: int, elt: int, query_tile: int) -> int:
    """Shared memory (bytes) of one K2/K3/K4 block of `query_tile` query
    rows for a corpus of `elt` bytes an element: the ring of ROW_STAGES
    (query slice, corpus slice), each row's threshold, buffer count, list
    length and shared bound, and the candidate buffers. It depends on
    neither k nor D."""
    trans = layout == K4_LAYOUT
    xld = ROW_CORPUS_TILE if trans else ROW_DEPTH + 4
    x_rows = ROW_DEPTH if trans else ROW_CORPUS_TILE
    stage = query_tile * (ROW_DEPTH + 4) * 4 + x_rows * xld * elt
    return ROW_STAGES * stage + query_tile * 5 * 4 + query_tile * ROW_CAP * 8


def row_query_tile(B: int) -> int:
    """Query rows per K2/K3/K4 block: the smallest of ROW_SMALL_QUERY_TILES
    that holds the whole batch (QueryService's batches of 64, or a direct
    search of 32 to 63 queries), so that no half of the block's FMAs goes
    to padding rows; else ROW_QUERY_TILE."""
    return next((t for t in ROW_SMALL_QUERY_TILES if B <= t), ROW_QUERY_TILE)


@dataclass(frozen=True)
class RowPlan:
    """What the K2/K3/K4 wrapper hands to `flat_topk_rows`."""
    layout: int
    query_tile: int
    corpus_tile: int
    depth_step: int
    stages: int
    splits: int
    rows_per_split: int
    grid_x: int         # query-tile blocks
    smem: int           # bytes per block
    work_entries: int   # scratch entries per scores and per ids
    bound_entries: int  # the bounds the splits share, [B, splits] f32


def row_plan(layout: int, B: int, N: int, k: int, elt: int,
             group: int = MERGE_GROUP) -> RowPlan:
    """The launch of K2 (layout 1), K3 (2, K2's schedule) or K4 (3) for B
    queries over N corpus rows of `elt` bytes: the query tile from B, the
    same tiles for every k, enough splits to fill the card, whole corpus
    tiles per split."""
    if layout not in (K2_LAYOUT, K3_LAYOUT, K4_LAYOUT):
        raise ValueError(f"layout {layout} is not a row-tile layout")
    tile = row_query_tile(B)
    splits, rows = _plan(B, N, layout, tile)
    return RowPlan(layout, tile, ROW_CORPUS_TILE, ROW_DEPTH, ROW_STAGES, splits, rows,
                   -(-B // tile), row_smem(layout, elt, tile), work_entries(B, k, splits, group),
                   B * splits)


def uses_tensor_cores(q_dtype: torch.dtype, x_dtype: torch.dtype, layout: int) -> bool:
    """The pass-1 route of K1-K4 on a card, set by the inputs: bf16 rows in
    K1's, K2's or K3's layout run on the tensor cores for bf16 and f32
    queries (K1tc, and K2tc or K2tc3): a bf16 query multiplies the rows as
    they are, where bf16 products are exact in f32 as in the TPU kernel's
    dot, and an f32 query (`ShardedFlatIndex`, as the JAX sharded scan
    hands them) as its three bf16 pieces (`QUERY_PIECES`), whose products
    are exact too. f32 rows stay on `topk_pass1` (K1) and `rows_pass1`
    (K2, K3), and K4 over any xt on `rows_pass1`. A contract, not a
    fallback: each route launches its kernel or raises."""
    return (x_dtype == torch.bfloat16 and q_dtype in QUERY_PIECES
            and layout in (K1_LAYOUT, K2_LAYOUT, K3_LAYOUT))


def tc_smem(query_tile: int, resident: bool, stages: int, D: int, elt: int = 2,
            meta: int = 4, pieces: int = 1) -> int:
    """Shared memory (bytes) of one tensor-core block whose operands take
    `elt` bytes an element and whose tiles bring `meta` bytes a corpus row
    through the meta slots (K2tc: bf16 and its bias, the defaults; K6/K7:
    int8 and its scale and bias, 1 and 8), with the query in `pieces`
    parts (K2tc3: 3): a 1 KB alignment margin, the ring (a corpus box of
    TC_TILE_N rows x TC_BOX_BYTES a stage, and the query pieces' boxes of
    query_tile x TC_BOX_BYTES when the query tile streams), the resident
    query tile (a box per piece and TC_BOX_BYTES of depth), TC_META_SLOTS
    meta slots, the flush staging areas (TC_BUF_CAP entries a half-warp),
    five 4-byte states for each of TC_SLOTS rows, and the barriers. It
    does not depend on k."""
    chunks = -(-D * elt // TC_BOX_BYTES)
    stage = TC_TILE_N * TC_BOX_BYTES + (0 if resident else pieces * query_tile * TC_BOX_BYTES)
    query = pieces * chunks * query_tile * TC_BOX_BYTES if resident else 0
    return (1024 + stages * stage + query + TC_META_SLOTS * meta * TC_TILE_N
            + TC_HALF_WARPS * TC_BUF_CAP * 8 + TC_SLOTS * 5 * 4
            + (2 * stages + 1 + 2 * TC_META_SLOTS) * 8)


@dataclass(frozen=True)
class TcPlan:
    """What a tensor-core wrapper hands to its kernel: K2tc to
    `flat_topk_tc`, K6/K7 to `int8_topk_tc` (`ops/quantize.py`)."""
    query_tile: int
    resident: bool
    stages: int
    splits: int
    rows_per_split: int
    grid_x: int         # query-tile blocks
    smem: int           # bytes per block
    work_entries: int   # scratch entries per scores and per ids
    bound_entries: int  # the bounds the splits share, [B, splits] f32
    cand_entries: int   # candidate buffer entries per scores and per ids


def _one_wave(b_tiles: int, N: int, blocks: int) -> Tuple[int, int]:
    """(splits, rows_per_split) of a tensor-core kernel: as many corpus
    splits of whole TC_TILE_N-row tiles as keep b_tiles query tiles x
    splits within `blocks` (one wave), and no empty split."""
    n_tiles = -(-N // TC_TILE_N)
    splits = max(1, min(n_tiles, blocks // b_tiles))
    rows = -(-n_tiles // splits) * TC_TILE_N
    return -(-N // rows), rows


def tc_plan(B: int, N: int, D: int, k: int, elt: int = 2, meta: int = 4,
            group: int = MERGE_GROUP, sms: int = TC_SMS, pieces: int = 1) -> TcPlan:
    """The launch of a tensor-core kernel (`elt`, `meta` and `pieces` as in
    `tc_smem`; the defaults are K2tc's) for B queries over N corpus rows of
    depth D on a card of `sms` SMs: a 64-row query tile for a batch of at
    most 64, else 128 rows; the resident query tile with the most ring
    stages that fit (else a streamed one), the same shared memory for every
    k; as many splits as keep all blocks in one wave of one block per SM,
    whole corpus tiles per split."""
    qt = TC_WG_ROWS if B <= TC_WG_ROWS else 2 * TC_WG_ROWS
    smem = lambda res, n: tc_smem(qt, res, n, D, elt, meta, pieces)  # noqa: E731
    resident, stages = next(((res, n) for res in (True, False) for n in TC_STAGES
                             if smem(res, n) <= SMEM_PER_BLOCK), (False, TC_STAGES[-1]))
    b_tiles = -(-B // qt)
    splits, rows = _one_wave(b_tiles, N, sms)
    return TcPlan(qt, resident, stages, splits, rows, b_tiles, smem(resident, stages),
                  work_entries(B, k, splits, group), B * splits,
                  b_tiles * splits * TC_SLOTS * TC_BUF_CAP)


def tc_l2_bytes(plan: TcPlan, N: int, D: int, elt: int = 2, pieces: int = 1) -> int:
    """Bytes a tensor-core launch's blocks read (from L2 or HBM) by its plan:
    each block the ring's stages over its split's corpus tiles (a corpus
    box and, when the query tile streams, its pieces' boxes a stage) and,
    when resident, its query tile once."""
    chunks = -(-D * elt // TC_BOX_BYTES)
    stage = TC_TILE_N * TC_BOX_BYTES + (0 if plan.resident else
                                        pieces * plan.query_tile * TC_BOX_BYTES)
    tiles = -(-N // TC_TILE_N)
    query = pieces * chunks * plan.query_tile * TC_BOX_BYTES if plan.resident else 0
    return plan.grid_x * (tiles * chunks * stage + plan.splits * query)


def k1tc_query_tile(B: int) -> int:
    """K1tc's query rows a block: B rounded up to a multiple of 8, at most
    the largest of K1TC_QUERY_TILES."""
    return next((t for t in K1TC_QUERY_TILES if B <= t), K1TC_QUERY_TILES[-1])


def k1tc_smem(query_tile: int, pieces: int, resident: bool, stages: int, D: int) -> int:
    """Shared memory (bytes) of one K1tc block (csrc/flat_topk_k1tc.cu
    `K1Layout`): a 1 KB alignment margin, the ring (a corpus box of
    TC_TILE_N rows x TC_BOX_BYTES a stage, and the query pieces' boxes of
    query_tile x TC_BOX_BYTES when the query tile streams), the resident
    query tile (a box per piece and TC_BOX_BYTES of depth), TC_META_SLOTS
    bias slots of TC_TILE_N f32, a candidate buffer of TC_BUF_CAP entries
    and five 4-byte states for each query of the tile, and the barriers.
    It does not depend on k."""
    chunks = -(-D * 2 // TC_BOX_BYTES)
    box = query_tile * TC_BOX_BYTES
    stage = TC_TILE_N * TC_BOX_BYTES + (0 if resident else pieces * box)
    query = pieces * chunks * box if resident else 0
    return (1024 + stages * stage + query + TC_META_SLOTS * 4 * TC_TILE_N
            + query_tile * TC_BUF_CAP * 8 + query_tile * 5 * 4
            + (2 * stages + 1 + 2 * TC_META_SLOTS) * 8)


@dataclass(frozen=True)
class K1Plan:
    """What the K1tc wrapper hands to `flat_topk_k1tc`."""
    query_tile: int
    pieces: int
    resident: bool
    stages: int
    splits: int
    rows_per_split: int
    grid_x: int         # query-tile blocks
    smem: int           # bytes per block
    work_entries: int   # scratch entries per scores and per ids
    bound_entries: int  # the bounds the splits share, [B, splits] f32


def k1tc_plan(B: int, N: int, D: int, k: int, pieces: int = 1, group: int = MERGE_GROUP,
              sms: int = TC_SMS) -> K1Plan:
    """The launch of K1tc for B queries of `pieces` bf16 parts over N bf16
    rows of depth D on a card of `sms` SMs: the query tile from B
    (`k1tc_query_tile`); the resident query tile with the most ring stages
    that fit, else a streamed one, the same shared memory for every k; as
    many splits as keep all blocks in one wave of one block per SM, whole
    corpus tiles per split."""
    qt = k1tc_query_tile(B)
    smem = lambda res, n: k1tc_smem(qt, pieces, res, n, D)  # noqa: E731
    resident, stages = next(((res, n) for res in (True, False) for n in K1TC_STAGES
                             if smem(res, n) <= SMEM_PER_BLOCK), (False, K1TC_STAGES[-1]))
    b_tiles = -(-B // qt)
    splits, rows = _one_wave(b_tiles, N, sms)
    return K1Plan(qt, pieces, resident, stages, splits, rows, b_tiles, smem(resident, stages),
                  work_entries(B, k, splits, group), B * splits)


def _outputs(B: int, k: int, n_work: int, dev):
    return (torch.empty((B, k), dtype=torch.float32, device=dev),
            torch.empty((B, k), dtype=torch.int32, device=dev),
            torch.empty((max(1, n_work),), dtype=torch.float32, device=dev),
            torch.empty((max(1, n_work),), dtype=torch.int32, device=dev))


def _launch_col(q, x, bias, k: int, tm: int):
    """K1 over f32 rows: column warps, tm query rows per block."""
    lib = _lib()
    B, D = q.shape
    N = x.shape[0]
    q = q.float().contiguous()  # bf16 queries widen exactly
    splits, rows = _plan(B, N, K1_LAYOUT, tm)
    out_s, out_i, work_s, work_i = _outputs(B, k, work_entries(B, k, splits), q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flat_topk(
        q.data_ptr(), x.data_ptr(), bias.data_ptr(), B, N, D, k, tm, splits, rows, MERGE_GROUP,
        out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"flat_topk kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, K1 tm={tm})")
    return out_s, out_i


def _launch_rows(q, x, bias, k: int, layout: int):
    """K2/K3/K4: the row-tile schedule; x is xt [D, N] for K4."""
    lib = _lib()
    B, D = q.shape
    N = x.shape[1] if layout == K4_LAYOUT else x.shape[0]
    elt = x.element_size()
    plan = row_plan(layout, B, N, k, elt)
    if lib.flat_topk_rows_smem(layout, int(elt == 2), plan.query_tile) != plan.smem or \
            lib.flat_topk_work_entries(B, k, plan.splits, MERGE_GROUP) != plan.work_entries:
        raise RuntimeError("ops/topk.py row_plan disagrees with csrc/flat_topk.cu")
    # queries as [B, ldq] f32 rows in 16-byte pieces: zero columns up to a
    # multiple of 4, 16-byte aligned (bf16 queries widen exactly)
    q = q.float().contiguous()
    if D % 4:
        q = torch.nn.functional.pad(q, (0, 4 - D % 4))
    if q.data_ptr() % 16:
        q = q.clone()
    vec = int(layout == K4_LAYOUT and N % (16 // elt) == 0 and x.data_ptr() % 16 == 0)
    out_s, out_i, work_s, work_i = _outputs(B, k, plan.work_entries, q.device)
    bound = torch.full((plan.bound_entries,), NEG_INF, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flat_topk_rows(
        q.data_ptr(), q.shape[1], x.data_ptr(), int(elt == 2), bias.data_ptr(), B, N, D, k,
        layout, plan.splits, plan.rows_per_split, plan.grid_x, plan.query_tile, vec, plan.smem,
        MERGE_GROUP, out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(),
        bound.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"flat_topk_rows kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, layout={layout}, {plan})")
    return out_s, out_i


def _query_pieces(q: torch.Tensor) -> torch.Tensor:
    """q [B, D] as its bf16 pieces [pieces, B, D], contiguous and 16-byte
    aligned for TMA: a bf16 q as it is, an f32 q as `split_bf16`'s hi, mid
    and lo (hi + mid + lo == q), an elementwise pass over the batch."""
    if q.dtype == torch.bfloat16:
        return q[None] if q.data_ptr() % 16 == 0 else q[None].clone()
    return torch.stack(split_bf16(q.float()))


def _launch_k1tc(q, x, bias, k: int):
    """K1tc: `bf16_k1_pass1` as `k1tc_plan` lays it out, then pass 2; the
    rows stay bf16 and the query goes to the tensor cores in its bf16
    pieces."""
    lib = _k1tc_lib()
    B, D = q.shape
    N = x.shape[0]
    pieces = QUERY_PIECES[q.dtype]
    plan = k1tc_plan(B, N, D, k, pieces,
                     sms=torch.cuda.get_device_properties(q.device).multi_processor_count)
    if lib.flat_topk_k1tc_smem(plan.query_tile, pieces, int(plan.resident), plan.stages, D) \
            != plan.smem or \
            lib.flat_topk_k1tc_work_entries(B, k, plan.splits, MERGE_GROUP) != plan.work_entries:
        raise RuntimeError("ops/topk.py k1tc_plan disagrees with csrc/flat_topk_k1tc.cu")
    qp = _query_pieces(q)
    if bias.data_ptr() % 16:  # TMA reads bias from 16-byte aligned addresses (x: `_check`)
        bias = bias.clone()
    out_s, out_i, work_s, work_i = _outputs(B, k, plan.work_entries, q.device)
    bound = torch.full((plan.bound_entries,), NEG_INF, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flat_topk_k1tc(
        qp.data_ptr(), pieces, x.data_ptr(), bias.data_ptr(), B, N, D, k, plan.query_tile,
        int(plan.resident), plan.stages, plan.splits, plan.rows_per_split, plan.smem, MERGE_GROUP,
        out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(),
        bound.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"flat_topk_k1tc kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, {plan})")
    return out_s, out_i


def _launch_tc(q, x, bias, k: int):
    """K2tc (bf16 q) and K2tc3 (f32 q): `bf16_tc_pass1` as `tc_plan` lays
    it out, then pass 2. x stays bf16 and q goes in its bf16 pieces: the
    tensor cores multiply them as the TPU kernel's dot."""
    lib = _tc_lib()
    B, D = q.shape
    N = x.shape[0]
    pieces = QUERY_PIECES[q.dtype]
    plan = tc_plan(B, N, D, k, sms=torch.cuda.get_device_properties(q.device).multi_processor_count,
                   pieces=pieces)
    if lib.flat_topk_tc_smem(plan.query_tile, int(plan.resident), plan.stages, D, pieces) \
            != plan.smem \
            or lib.flat_topk_tc_work_entries(B, k, plan.splits, MERGE_GROUP) != plan.work_entries \
            or lib.flat_topk_tc_cand_entries(B, plan.query_tile, plan.splits) != plan.cand_entries:
        raise RuntimeError("ops/topk.py tc_plan disagrees with csrc/flat_topk_tc.cu")
    qp = _query_pieces(q)
    if bias.data_ptr() % 16:  # TMA reads bias from 16-byte aligned addresses (x: `_check`)
        bias = bias.clone()
    out_s, out_i, work_s, work_i = _outputs(B, k, plan.work_entries, q.device)
    bound = torch.full((plan.bound_entries,), NEG_INF, dtype=torch.float32, device=q.device)
    cand_s = torch.empty((plan.cand_entries,), dtype=torch.float32, device=q.device)
    cand_i = torch.empty((plan.cand_entries,), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flat_topk_tc(
        qp.data_ptr(), pieces, x.data_ptr(), bias.data_ptr(), B, N, D, k, plan.query_tile,
        int(plan.resident), plan.stages, plan.splits, plan.rows_per_split, plan.smem, MERGE_GROUP,
        out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(),
        bound.data_ptr(), cand_s.data_ptr(), cand_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"flat_topk_tc kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, {plan})")
    return out_s, out_i


def k1_tm(B: int) -> int:
    """K1's query rows per block: B rounded up to 1, 2, 4 or 8."""
    return next(tm for tm in (1, 2, 4, 8) if tm >= min(B, 8))


def query_tile(layout: int, tm: int) -> int:
    """Query rows per block of the int8 kernels (csrc/int8_topk.cu): tm
    for column warps, 8 * tm for row warps."""
    return tm if layout == K1_LAYOUT else 8 * tm


def row_warps_tm(pass1_smem, layout: int, B: int, k: int, D: int, tms, budget: int) -> int:
    """Micro-tile rows of the int8 row-warp layouts (K6/K7, query tile
    8 * tm): the largest of `tms` whose pass-1 shared memory
    (`pass1_smem(layout, tm, k, D)`: lists, operand tiles and, for a
    resident query tile, the tile) fits `budget`, and no larger than the
    batch needs; the smallest when none fits (the launch then reports it)."""
    for tm in tms:
        if tm > tms[-1] and 4 * tm >= B:
            continue  # half the tile would be padding
        if pass1_smem(layout, tm, k, D) <= budget:
            return tm
    return tms[-1]


def streaming_topk_cuda(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: exact top-k for small query batches (query tiles of up to 8
    rows, corpus split across blocks). CPU tensors run `streaming_topk`
    (tile_n is its tile); CUDA tensors launch the kernel, which needs D a
    multiple of 8. bf16 rows run `streaming_topk_cuda_k1tc` (the tensor
    cores, `uses_tensor_cores`) and count in its launches. Returns (scores
    [B, k] f32, ids [B, k] int32)."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x, bias, k, tile_n)
    _check(q, x, bias, k)
    if uses_tensor_cores(q.dtype, x.dtype, K1_LAYOUT):
        return streaming_topk_cuda_k1tc(q, x, bias, k, tile_n)
    out = _launch_col(q, x, bias, k, k1_tm(q.shape[0]))
    with _count_lock:
        streaming_topk_cuda.launches += 1
    return out


def streaming_topk_cuda_qmajor(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: exact top-k for large query batches (128-row query tiles for
    every k, so each corpus tile read serves 128 queries, or 32- or 64-row
    tiles for a batch that fits one; the top-k lists live in device memory
    behind a per-row threshold and candidate buffer). bf16 rows run on the
    tensor cores (`uses_tensor_cores`): bf16 queries as
    `streaming_topk_cuda_tc`, f32 queries as `streaming_topk_cuda_tc3`,
    each counting in its own launches. Same contract as
    `streaming_topk_cuda`."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x, bias, k, tile_n)
    _check(q, x, bias, k)
    if uses_tensor_cores(q.dtype, x.dtype, K2_LAYOUT):
        return _tc_route(q)(q, x, bias, k, tile_n)
    out = _launch_rows(q, x, bias, k, K2_LAYOUT)
    with _count_lock:
        streaming_topk_cuda_qmajor.launches += 1
    return out


def streaming_topk_cuda_qres(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: exact top-k with the batch sharing the corpus reads. It runs
    K2's schedule, whose query tiles of a corpus split read each corpus
    slice from the 50 MB L2 within a few microseconds of each other (a
    thread block cluster sharing each slice ran about twice as slow on an
    H100: PERF.md). bf16 rows run on the tensor cores, as K2's do. Same
    contract as `streaming_topk_cuda`."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x, bias, k, tile_n)
    _check(q, x, bias, k)
    if uses_tensor_cores(q.dtype, x.dtype, K3_LAYOUT):
        return _tc_route(q)(q, x, bias, k, tile_n)
    out = _launch_rows(q, x, bias, k, K3_LAYOUT)
    with _count_lock:
        streaming_topk_cuda_qres.launches += 1
    return out


def _tensor_core_scan(q, x, bias, k, tile_n, q_dtype, launch, counted):
    """A tensor-core wrapper's body: the plain version on CPU tensors; on
    CUDA tensors its kernel over bf16 rows and `q_dtype` queries (or a
    raise), counted in `counted.launches`."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x, bias, k, tile_n)
    _check(q, x, bias, k)
    if x.dtype != torch.bfloat16 or q.dtype not in q_dtype:
        names = " or ".join("bf16" if d == torch.bfloat16 else "f32" for d in q_dtype)
        raise ValueError(f"the tensor-core kernel takes {names} queries over bf16 rows, got q "
                         f"{q.dtype} over x {x.dtype}")
    out = launch(q, x, bias, k)
    with _count_lock:
        counted.launches += 1
    return out


def streaming_topk_cuda_tc(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 and K3 over bf16 queries and bf16 rows ("K2tc"): `wgmma` bf16 on
    the tensor cores with TMA-fed operands (64- or 128-row query tiles,
    resident where they fit, else streamed with the corpus; the top-k
    lists in device memory behind a per-row threshold and candidate
    buffer, so every k takes the same tile). CPU tensors run
    `streaming_topk`; CUDA tensors launch the kernel, which takes bf16 q
    and x only (D a multiple of 8), or raise. Returns (scores [B, k] f32,
    ids [B, k] int32)."""
    return _tensor_core_scan(q, x, bias, k, tile_n, (torch.bfloat16,), _launch_tc,
                             streaming_topk_cuda_tc)


def streaming_topk_cuda_tc3(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 and K3 over f32 queries and bf16 rows ("K2tc3"): K2tc's kernel
    with each f32 query as its three bf16 pieces hi + mid + lo == q
    (`split_bf16`), three products into one f32 accumulator, so the
    scores are the f32 query's. CPU tensors run `streaming_topk`; CUDA
    tensors launch the kernel, which takes f32 q over bf16 x only (D a
    multiple of 8), or raise."""
    return _tensor_core_scan(q, x, bias, k, tile_n, (torch.float32,), _launch_tc,
                             streaming_topk_cuda_tc3)


def streaming_topk_cuda_k1tc(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 over bf16 rows ("K1tc"): `wgmma` on the tensor cores with the
    corpus box as the 64-row operand and up to 32 queries as the other,
    fed by TMA; bf16 queries as they are, f32 queries as their three bf16
    pieces; per-query candidate buffers in shared memory behind the
    list's k-th entry and the bound the corpus splits share. CPU tensors
    run `streaming_topk`; CUDA tensors launch the kernel, which takes bf16
    or f32 q over bf16 x (D a multiple of 8), or raise."""
    return _tensor_core_scan(q, x, bias, k, tile_n, (torch.bfloat16, torch.float32),
                             _launch_k1tc, streaming_topk_cuda_k1tc)


def _tc_route(q: torch.Tensor):
    """K2's and K3's wrapper over bf16 rows for q's dtype."""
    return streaming_topk_cuda_tc if q.dtype == torch.bfloat16 else streaming_topk_cuda_tc3


def _check_xt(q: torch.Tensor, xt: torch.Tensor, bias: torch.Tensor, k: int) -> None:
    """`_check` for a corpus xt [D, N], which K4 reads along N one element
    at a time: no condition on D or alignment."""
    if xt.dim() != 2 or q.dim() != 2 or bias.dim() != 1 or q.shape[1] != xt.shape[0] \
            or bias.shape[0] != xt.shape[1]:
        raise ValueError(f"shape mismatch: expected q [B, D], xt [D, N], bias [N], got q "
                         f"{tuple(q.shape)}, xt {tuple(xt.shape)}, bias {tuple(bias.shape)}")
    if q.shape[0] < 1 or xt.shape[1] < 1:
        raise ValueError("empty query batch or corpus")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if xt.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xt must be float32 or bfloat16, got {xt.dtype}")
    if bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {bias.dtype}")
    if not (q.is_contiguous() and xt.is_contiguous() and bias.is_contiguous()):
        raise ValueError("q, xt and bias must be contiguous")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    if xt.shape[1] >= 2**31 - 1024 or xt.numel() >= 2**62:
        raise ValueError("corpus too large for 32-bit row ids")


def streaming_topk_cuda_qmajor_xt(
    q: torch.Tensor, xt: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: K2 over a pre-transposed corpus xt [D, N] (any N and D); its
    results equal K2's on xt.T. CPU tensors run `streaming_topk` on xt.T.
    Returns (scores [B, k] f32, ids [B, k] int32)."""
    if _on_cpu(q, xt, bias):
        return streaming_topk(q, xt.T, bias, k, tile_n)
    _check_xt(q, xt, bias, k)
    out = _launch_rows(q, xt, bias, k, K4_LAYOUT)
    with _count_lock:
        streaming_topk_cuda_qmajor_xt.launches += 1
    return out


streaming_topk_cuda.launches = 0
streaming_topk_cuda_qmajor.launches = 0
streaming_topk_cuda_qres.launches = 0
streaming_topk_cuda_qmajor_xt.launches = 0
streaming_topk_cuda_tc.launches = 0
streaming_topk_cuda_tc3.launches = 0
streaming_topk_cuda_k1tc.launches = 0


__all__ = [
    "NEG_INF",
    "DEFAULT_TILE_N",
    "MAX_K",
    "exact_topk",
    "merge_topk",
    "streaming_topk",
    "streaming_topk_cuda",
    "streaming_topk_cuda_qmajor",
    "streaming_topk_cuda_qres",
    "streaming_topk_cuda_qmajor_xt",
    "streaming_topk_cuda_tc",
    "streaming_topk_cuda_tc3",
    "streaming_topk_cuda_k1tc",
    "k1tc_plan",
    "tc_plan",
    "uses_tensor_cores",
]

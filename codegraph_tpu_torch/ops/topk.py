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
  in its own launches. So does K4 over a bf16 xt [D, N]: where TMA can
  read it (`xt_tma_readable`: N % 8 == 0, a 16-byte aligned base) as
  `streaming_topk_cuda_tc_xt` ("K4tc") and `streaming_topk_cuda_tc3_xt`
  ("K4tc3"), K2tc's kernel and plan with the corpus boxes read MN-major,
  and otherwise as `streaming_topk_cuda_tc_xt_ragged` ("K4tcr") and
  `streaming_topk_cuda_tc3_xt_ragged` ("K4tc3r"), the same kernel with the
  two boxes of each stage written by the ragged-row producer
  (`swizzled_xt_stage` models them). An f32 xt runs `rows_pass1`, in
  16-byte pieces where N % 4 == 0 and the base is 16-byte aligned, else
  in 4-byte pieces as `streaming_topk_cuda_qmajor_xt_ragged` ("K4r";
  `flat_route` of xt names the route).
* Every embedding width runs on the card, as the JAX kernels take any D
  (`flat_route` says how rows are read). bf16 rows that TMA cannot read
  (a row not a multiple of 16 bytes, or a base not 16-byte aligned) run
  the same tensor-core kernels with their corpus brought by the ragged-row
  producer of `csrc/hopper_tc.cuh`, which lays each stage out as a TMA box
  would (`swizzled_box` is its numpy model): `streaming_topk_cuda_k1tc_ragged`
  ("K1tcr"), `streaming_topk_cuda_tc_ragged` ("K2tcr") and
  `streaming_topk_cuda_tc3_ragged` ("K2tc3r"). f32 rows that 16-byte pieces
  cannot read (D % 4 != 0, or a base not 16-byte aligned) run K1 and K2/K3
  in 4-byte pieces: `streaming_topk_cuda_ragged` ("K1r") and
  `streaming_topk_cuda_qmajor_ragged` ("K2r"). Each counts its own
  launches; the queries are padded with zero columns (B x D bytes), never
  the corpus.

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
#: row tiles (`rows_pass1`, f32 rows or an f32 xt: 128 query rows x 128
#: corpus rows per block for every k, each thread an 8 x 8 micro tile, or
#: 32 or 64 query rows when the batch fits them; K3 runs K2's schedule; K4
#: reads the corpus from xt [D, N]). csrc/int8_topk.cu's K5 takes K1's
#: corpus tile and plan, with tm query rows a block.
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
#: rows, and K4tc over a bf16 xt, csrc/flat_topk_tc.cu `bf16_tc_pass1`)
#: and K6/K7 (int8, csrc/int8_topk.cu `int8_tc_pass1`), share one block
#: design, whose `TcLayoutOf` (csrc/hopper_tc.cuh) `tc_smem` mirrors: a consumer
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

#: how the ragged-row producer (csrc/hopper_tc.cuh) and the FMA kernels
#: copy a row: cp.async pieces of 16, 8 or 4 bytes, or (1) the aligned
#: words that hold each chunk, realigned
PIECE_NAMES = {16: "16-byte pieces", 8: "8-byte pieces", 4: "4-byte pieces", 1: "bytes"}


def load_piece(row_bytes: int, addr: int) -> int:
    """The widest copy (16, 8 or 4 bytes) that both the row stride
    `row_bytes` and the base address `addr` are multiples of, so that every
    piece of every row is aligned; 1 where none is (an odd int8 or bf16
    width, or a base one element in): the kernels then read aligned words
    and realign them."""
    return next((p for p in (16, 8, 4) if row_bytes % p == 0 and addr % p == 0), 1)


def rows_tma_readable(row_bytes: int, *addrs: int) -> bool:
    """Whether TMA's tiled mode reads rows of `row_bytes` (their stride) at
    these base addresses: a stride that is a multiple of 16 bytes, and
    every base 16-byte aligned."""
    return row_bytes % 16 == 0 and all(a % 16 == 0 for a in addrs)


def flat_route(x: torch.Tensor) -> str:
    """How K1-K3 read the rows x [N, D] on a card, from D and x's address:
    bf16 rows "tma" (K1tc, K2tc, K2tc3) or "ragged, <piece>" (K1tcr, K2tcr,
    K2tc3r: the ragged-row producer's copies, `load_piece`); f32 rows
    "16-byte pieces" (K1, K2) or "4-byte pieces" (K1r, K2r). Every width
    and address torch hands over takes one of them. K4 reads xt [D, N] by
    the same rule over its rows of N: a bf16 xt "tma" (K4tc, K4tc3,
    `xt_tma_readable`) or "ragged, <piece>" (K4tcr, K4tc3r), an f32 xt
    "16-byte pieces" (K4) or "4-byte pieces" (K4r)."""
    row_bytes, addr = x.shape[1] * x.element_size(), x.data_ptr()
    if x.dtype == torch.bfloat16:
        if rows_tma_readable(row_bytes, addr):
            return "tma"
        return "ragged, " + PIECE_NAMES[load_piece(row_bytes, addr)]
    return PIECE_NAMES[16] if load_piece(row_bytes, addr) == 16 else PIECE_NAMES[4]


def swizzled_xt_stage(xt_bytes, n0: int, c: int):
    """numpy model of one ring stage of K4tcr/K4tc3r over a bf16 corpus
    stored as xt [D, N] (csrc/hopper_tc.cuh `ragged_produce` with XT): the
    two MN-major boxes that K4tc's TMA loads bring (columns n0 .. n0 + 127
    at depths c * 64 .. c * 64 + 63), written by the ragged-row producer.
    xt_bytes: [D, 2N] uint8, xt's bytes. Box h (at h * 8192 bytes) is the
    `swizzled_box` of 64 rows from row r0 = c * 64 at byte offset off0 =
    2 * (n0 + 64 h): its rows are xt's depths, its bytes 64 columns, zeros
    past N (bytes past 2N) and past D. Returns [2 * 64 * 128] uint8."""
    import numpy as np

    return np.concatenate([swizzled_box(xt_bytes, c * 64, 0, R=64, off0=2 * (n0 + 64 * h))
                           for h in range(2)])


def swizzled_box(rows, n0: int, c: int, R: int = 128, off0: Optional[int] = None):
    """numpy model of one ring stage of the tensor-core kernels: the bytes a
    TMA box of R rows x 128 bytes with the 128-byte swizzle holds, which
    the ragged-row producer (csrc/hopper_tc.cuh `ragged_fill`) writes
    itself. rows: [N, row_bytes] uint8, the corpus's bytes. Box row r is
    corpus row n0 + r, bytes c * 128 .. c * 128 + 127 of it, stored at r *
    128 with its 16-byte chunk j at chunk j ^ (r & 7); zeros past the
    row's bytes and past N. off0 (default c * 128) is the first byte of the
    box in each row, as the producer takes it (`ragged_fill`'s off0).
    Returns [R * 128] uint8."""
    import numpy as np

    rows = np.asarray(rows, np.uint8)
    N, row_bytes = rows.shape
    box = np.zeros((R, 128), np.uint8)
    lo = c * 128 if off0 is None else off0
    width = max(0, min(128, row_bytes - lo))
    live = max(0, min(R, N - n0))
    box[:live, :width] = rows[n0: n0 + live, lo: lo + width]
    out = np.zeros((R, 8, 16), np.uint8)
    for r in range(R):
        out[r, np.arange(8) ^ (r & 7)] = box[r].reshape(8, 16)
    return out.reshape(-1)


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
        lib.flat_topk_k1tc.argtypes = [p, i, p, p, i, i, i, i, i, i, i, i, i, ll, i, i,
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
        lib.flat_topk_tc.argtypes = [p, i, p, i, p, i, i, i, i, i, i, i, i, i, ll, i, i,
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
        lib.flat_topk.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
        lib.flat_topk.restype = i
        lib.flat_topk_rows.argtypes = [p, i, p, p, i, i, i, i, i, i, i, i, i, i, ll, i,
                                       p, p, p, p, p, p]
        lib.flat_topk_rows.restype = i
        lib.flat_topk_rows_smem.argtypes = [i, i]
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
    if x.data_ptr() % x.element_size() or bias.data_ptr() % 4:
        raise ValueError("x and bias must be aligned to their element size")
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
    rows for a corpus of `elt` bytes an element (4: `rows_pass1` reads f32
    rows and an f32 xt; a bf16 corpus runs on the tensor cores, so 2
    raises): the ring of ROW_STAGES (query slice, corpus slice), each row's
    threshold, buffer count, list length and shared bound, and the
    candidate buffers. It depends on neither k nor D."""
    if elt != 4:
        raise ValueError(f"rows_pass1 reads f32 rows (4 bytes an element), not {elt}-byte "
                         "elements: a bf16 corpus runs on the tensor cores")
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
    queries over N f32 corpus rows (`elt` = 4; `row_smem` refuses others):
    the query tile from B, the same tiles for every k, enough splits to
    fill the card, whole corpus tiles per split."""
    if layout not in (K2_LAYOUT, K3_LAYOUT, K4_LAYOUT):
        raise ValueError(f"layout {layout} is not a row-tile layout")
    tile = row_query_tile(B)
    splits, rows = _plan(B, N, layout, tile)
    return RowPlan(layout, tile, ROW_CORPUS_TILE, ROW_DEPTH, ROW_STAGES, splits, rows,
                   -(-B // tile), row_smem(layout, elt, tile), work_entries(B, k, splits, group),
                   B * splits)


def uses_tensor_cores(q_dtype: torch.dtype, x_dtype: torch.dtype) -> bool:
    """The pass-1 route of K1-K4 on a card, set by the inputs, the same in
    every layout: bf16 rows (K4: a bf16 xt) run on the tensor cores for
    bf16 and f32 queries (K1tc; K2tc or K2tc3; K4tc or K4tc3): a bf16
    query multiplies the rows as they are, where bf16 products are exact
    in f32 as in the TPU kernel's dot, and an f32 query
    (`ShardedFlatIndex`, as the JAX sharded scan hands them) as its three
    bf16 pieces (`QUERY_PIECES`), whose products are exact too. f32 rows
    stay on `topk_pass1` (K1) and `rows_pass1` (K2-K4). Whether TMA or the
    ragged-row producer brings the corpus (`flat_route`, and for K4's xt
    `xt_tma_readable`) picks the instance, not the unit. A contract, not a
    fallback: each route launches its kernel or raises."""
    return x_dtype == torch.bfloat16 and q_dtype in QUERY_PIECES


def xt_tma_readable(N: int, addr: int) -> bool:
    """Whether TMA can read a bf16 corpus xt [D, N] at device address
    `addr` (K4tc, K4tc3): every row of N elements a multiple of 16 bytes
    (N % 8 == 0), and the base 16-byte aligned. Any other bf16 xt runs
    K4tcr or K4tc3r (the ragged-row producer)."""
    return rows_tma_readable(2 * N, addr)


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
    does not depend on k. K4tc reads a stage's corpus from xt [D, N] as two
    boxes of TC_BOX_BYTES // 2 columns (the swizzle span) x TC_BOX_BYTES //
    2 depths: the same bytes, so the same layout."""
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


def _launch_col(q, x, bias, k: int, tm: int, piece: int = 16):
    """K1 over f32 rows: column warps, tm query rows per block, the rows in
    `piece`-byte pieces (16, or 4: K1r)."""
    lib = _lib()
    B, D = q.shape
    N = x.shape[0]
    q = q.float().contiguous()  # bf16 queries widen exactly
    splits, rows = _plan(B, N, K1_LAYOUT, tm)
    out_s, out_i, work_s, work_i = _outputs(B, k, work_entries(B, k, splits), q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flat_topk(
        q.data_ptr(), x.data_ptr(), bias.data_ptr(), B, N, D, k, tm, splits, rows, MERGE_GROUP,
        piece, out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"flat_topk kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, K1 tm={tm}, piece={piece})")
    return out_s, out_i


def _launch_rows(q, x, bias, k: int, layout: int, piece: int = 16):
    """K2/K3/K4: the row-tile schedule over f32 rows; x is xt [D, N] for
    K4; rows (xt's rows of N) in `piece`-byte pieces (16, or 4: K2r,
    K4r)."""
    lib = _lib()
    B, D = q.shape
    N = x.shape[1] if layout == K4_LAYOUT else x.shape[0]
    plan = row_plan(layout, B, N, k, x.element_size())
    if lib.flat_topk_rows_smem(layout, plan.query_tile) != plan.smem or \
            lib.flat_topk_work_entries(B, k, plan.splits, MERGE_GROUP) != plan.work_entries:
        raise RuntimeError("ops/topk.py row_plan disagrees with csrc/flat_topk.cu")
    # queries as [B, ldq] f32 rows in 16-byte pieces: zero columns up to a
    # multiple of 4, 16-byte aligned (bf16 queries widen exactly)
    q = q.float().contiguous()
    if D % 4:
        q = torch.nn.functional.pad(q, (0, 4 - D % 4))
    if q.data_ptr() % 16:
        q = q.clone()
    out_s, out_i, work_s, work_i = _outputs(B, k, plan.work_entries, q.device)
    bound = torch.full((plan.bound_entries,), NEG_INF, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flat_topk_rows(
        q.data_ptr(), q.shape[1], x.data_ptr(), bias.data_ptr(), B, N, D, k,
        layout, plan.splits, plan.rows_per_split, plan.grid_x, plan.query_tile, piece,
        plan.smem, MERGE_GROUP, out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(),
        work_i.data_ptr(),
        bound.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"flat_topk_rows kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, layout={layout}, piece={piece}, "
                           f"{plan})")
    return out_s, out_i


def _query_pieces(q: torch.Tensor) -> torch.Tensor:
    """q [B, D] as its bf16 pieces [pieces, B, Dq], contiguous and 16-byte
    aligned for TMA, with zero columns up to Dq, D rounded up to a multiple
    of 8 (TMA's 16-byte rows; the B x D queries are padded, never the
    corpus): a bf16 q as it is, an f32 q as `split_bf16`'s hi, mid and lo
    (hi + mid + lo == q), an elementwise pass over the batch."""
    if q.shape[1] % 8:
        q = torch.nn.functional.pad(q, (0, 8 - q.shape[1] % 8))
    if q.dtype == torch.bfloat16:
        return q[None] if q.data_ptr() % 16 == 0 else q[None].clone()
    return torch.stack(split_bf16(q.float()))


def _tc_piece(x: torch.Tensor, bias: torch.Tensor, ragged: bool) -> Tuple[int, torch.Tensor]:
    """(piece, bias) for a tensor-core launch over bf16 rows x: 0 and a
    16-byte aligned bias (cloned if it is not: 4 bytes a row) for the TMA
    instance; for the ragged one the producer's copy width (`load_piece`)
    and the bias as it is (4-byte copies)."""
    if ragged:
        return load_piece(x.shape[1] * 2, x.data_ptr()), bias
    return 0, bias if bias.data_ptr() % 16 == 0 else bias.clone()


def _launch_k1tc(q, x, bias, k: int, ragged: bool = False):
    """K1tc (K1tcr: ragged): `bf16_k1_pass1` as `k1tc_plan` lays it out,
    then pass 2; the rows stay bf16 and the query goes to the tensor cores
    in its bf16 pieces."""
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
    piece, bias = _tc_piece(x, bias, ragged)
    out_s, out_i, work_s, work_i = _outputs(B, k, plan.work_entries, q.device)
    bound = torch.full((plan.bound_entries,), NEG_INF, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flat_topk_k1tc(
        qp.data_ptr(), pieces, x.data_ptr(), bias.data_ptr(), B, N, D, k, plan.query_tile,
        int(plan.resident), plan.stages, plan.splits, plan.rows_per_split, plan.smem, MERGE_GROUP,
        piece, out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(),
        bound.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"flat_topk_k1tc kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, piece={piece}, {plan})")
    return out_s, out_i


def _launch_tc(q, x, bias, k: int, xt: bool = False, ragged: bool = False):
    """K2tc (bf16 q) and K2tc3 (f32 q) (K2tcr, K2tc3r: ragged):
    `bf16_tc_pass1` as `tc_plan` lays it out, then pass 2. x stays bf16 and
    q goes in its bf16 pieces: the tensor cores multiply them as the TPU
    kernel's dot. xt: x is xt [D, N] (K4tc, K4tc3; K4tcr, K4tc3r: ragged,
    the producer's rows xt's depths of 2N bytes), and q gets zero columns
    up to a multiple of 8 (TMA's 16-byte rows; xt's depths past D read as
    zeros)."""
    lib = _tc_lib()
    xt_depth = q.shape[1] if xt else 0
    if xt and xt_depth % 8:
        q = torch.nn.functional.pad(q, (0, 8 - xt_depth % 8))
    B, D = q.shape
    N = x.shape[1] if xt else x.shape[0]
    pieces = QUERY_PIECES[q.dtype]
    plan = tc_plan(B, N, D, k, sms=torch.cuda.get_device_properties(q.device).multi_processor_count,
                   pieces=pieces)
    if lib.flat_topk_tc_smem(plan.query_tile, int(plan.resident), plan.stages, D, pieces) \
            != plan.smem \
            or lib.flat_topk_tc_work_entries(B, k, plan.splits, MERGE_GROUP) != plan.work_entries \
            or lib.flat_topk_tc_cand_entries(B, plan.query_tile, plan.splits) != plan.cand_entries:
        raise RuntimeError("ops/topk.py tc_plan disagrees with csrc/flat_topk_tc.cu")
    qp = _query_pieces(q)
    piece, bias = _tc_piece(x, bias, ragged)
    out_s, out_i, work_s, work_i = _outputs(B, k, plan.work_entries, q.device)
    bound = torch.full((plan.bound_entries,), NEG_INF, dtype=torch.float32, device=q.device)
    cand_s = torch.empty((plan.cand_entries,), dtype=torch.float32, device=q.device)
    cand_i = torch.empty((plan.cand_entries,), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flat_topk_tc(
        qp.data_ptr(), pieces, x.data_ptr(), xt_depth, bias.data_ptr(), B, N, D, k, plan.query_tile,
        int(plan.resident), plan.stages, plan.splits, plan.rows_per_split, plan.smem, MERGE_GROUP,
        piece, out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(),
        bound.data_ptr(), cand_s.data_ptr(), cand_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"flat_topk_tc kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, xt_depth={xt_depth}, k={k}, piece={piece}, "
                           f"{plan})")
    return out_s, out_i


def _launch_tc_xt(q, xt, bias, k: int, ragged: bool = False):
    """K4tc (bf16 q) and K4tc3 (f32 q) (K4tcr, K4tc3r: ragged): `_launch_tc`
    over xt [D, N]."""
    return _launch_tc(q, xt, bias, k, xt=True, ragged=ragged)


def k1_tm(B: int) -> int:
    """K1's query rows per block: B rounded up to 1, 2, 4 or 8."""
    return next(tm for tm in (1, 2, 4, 8) if tm >= min(B, 8))


def streaming_topk_cuda(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: exact top-k for small query batches (query tiles of up to 8
    rows, corpus split across blocks). CPU tensors run `streaming_topk`
    (tile_n is its tile); CUDA tensors launch a kernel, at any D, by the
    route `flat_route` names: f32 rows in 16-byte pieces here, in 4-byte
    pieces as `streaming_topk_cuda_ragged` ("K1r"); bf16 rows on the
    tensor cores (`uses_tensor_cores`) as `streaming_topk_cuda_k1tc` or,
    rows TMA cannot read, `streaming_topk_cuda_k1tc_ragged`. Each counts
    in its own launches. Returns (scores [B, k] f32, ids [B, k] int32)."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x, bias, k, tile_n)
    _check(q, x, bias, k)
    route = flat_route(x)
    if uses_tensor_cores(q.dtype, x.dtype):
        fn = streaming_topk_cuda_k1tc if route == "tma" else streaming_topk_cuda_k1tc_ragged
        return fn(q, x, bias, k, tile_n)
    if route != PIECE_NAMES[16]:
        return streaming_topk_cuda_ragged(q, x, bias, k, tile_n)
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
    `streaming_topk_cuda_tc`, f32 queries as `streaming_topk_cuda_tc3`
    (rows TMA cannot read: their `_ragged` forms), each counting in its
    own launches; f32 rows that 16-byte pieces cannot read run
    `streaming_topk_cuda_qmajor_ragged` ("K2r"). Same contract as
    `streaming_topk_cuda`."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x, bias, k, tile_n)
    _check(q, x, bias, k)
    if uses_tensor_cores(q.dtype, x.dtype):
        return _tc_route(q, x)(q, x, bias, k, tile_n)
    if flat_route(x) != PIECE_NAMES[16]:
        return streaming_topk_cuda_qmajor_ragged(q, x, bias, k, tile_n)
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
    H100: PERF.md). bf16 rows run on the tensor cores, and f32 rows that
    16-byte pieces cannot read in 4-byte pieces, as K2's do (counted in
    those routes' launches). Same contract as `streaming_topk_cuda`."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x, bias, k, tile_n)
    _check(q, x, bias, k)
    if uses_tensor_cores(q.dtype, x.dtype):
        return _tc_route(q, x)(q, x, bias, k, tile_n)
    if flat_route(x) != PIECE_NAMES[16]:
        return streaming_topk_cuda_qmajor_ragged(q, x, bias, k, tile_n)
    out = _launch_rows(q, x, bias, k, K3_LAYOUT)
    with _count_lock:
        streaming_topk_cuda_qres.launches += 1
    return out


def _tensor_core_scan(q, x, bias, k, tile_n, q_dtype, launch, counted, xt=False, ragged=False):
    """A tensor-core wrapper's body: the plain version on CPU tensors; on
    CUDA tensors its kernel over bf16 rows, or with xt over a bf16 xt [D,
    N] (not ragged: rows, or an xt, that TMA can read; ragged: any,
    through the ragged-row producer) and `q_dtype` queries (or a raise),
    counted in `counted.launches`."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x.T if xt else x, bias, k, tile_n)
    (_check_xt if xt else _check)(q, x, bias, k)
    corpus = "a bf16 xt" if xt else "bf16 rows"
    if x.dtype != torch.bfloat16 or q.dtype not in q_dtype:
        names = " or ".join("bf16" if d == torch.bfloat16 else "f32" for d in q_dtype)
        raise ValueError(f"the tensor-core kernel takes {names} queries over {corpus}, got q "
                         f"{q.dtype} over x {x.dtype}")
    if xt and not ragged and not xt_tma_readable(x.shape[1], x.data_ptr()):
        raise ValueError(f"TMA reads xt [D, N] only with N % 8 == 0 and a 16-byte aligned base, "
                         f"got N={x.shape[1]} at {x.data_ptr() % 16} bytes past 16: the ragged "
                         "route (`_xt_ragged`) reads it")
    if not xt and not ragged and flat_route(x) != "tma":
        raise ValueError(f"TMA reads rows only of a multiple of 16 bytes from a 16-byte aligned "
                         f"base, got D={x.shape[1]} at {x.data_ptr() % 16} bytes past 16: the "
                         "ragged route (`_ragged`) reads them")
    out = launch(q, x, bias, k, ragged=True) if ragged else launch(q, x, bias, k)
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
    over bf16 rows that TMA can read only (`flat_route` "tma"), or
    raise. Returns (scores [B, k] f32, ids [B, k] int32)."""
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
    tensors launch the kernel, which takes f32 q over bf16 rows that TMA
    can read only, or raise."""
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
    or f32 q over bf16 rows that TMA can read, or raise."""
    return _tensor_core_scan(q, x, bias, k, tile_n, (torch.bfloat16, torch.float32),
                             _launch_k1tc, streaming_topk_cuda_k1tc)


def streaming_topk_cuda_k1tc_ragged(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 over bf16 rows of any width and base ("K1tcr"): K1tc's kernel
    with its corpus boxes and bias brought by the producer warp's own
    copies (csrc/hopper_tc.cuh's ragged-row producer: cp.async pieces of
    `load_piece` bytes, or realigned words), laid out as TMA's boxes; the
    queries, padded to a multiple of 8 columns, still come by TMA. K1
    sends it the rows TMA cannot read (`flat_route`); it takes any. CPU
    tensors run `streaming_topk`; CUDA tensors launch the kernel, which
    takes bf16 or f32 q over bf16 x, or raise."""
    return _tensor_core_scan(q, x, bias, k, tile_n, (torch.bfloat16, torch.float32),
                             _launch_k1tc, streaming_topk_cuda_k1tc_ragged, ragged=True)


def streaming_topk_cuda_tc_ragged(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 and K3 over bf16 queries and bf16 rows of any width and base
    ("K2tcr"): K2tc's kernel fed by the ragged-row producer, as
    `streaming_topk_cuda_k1tc_ragged` is K1tc's. Same contract as
    `streaming_topk_cuda_tc`, for any rows."""
    return _tensor_core_scan(q, x, bias, k, tile_n, (torch.bfloat16,), _launch_tc,
                             streaming_topk_cuda_tc_ragged, ragged=True)


def streaming_topk_cuda_tc3_ragged(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 and K3 over f32 queries (three bf16 pieces) and bf16 rows of any
    width and base ("K2tc3r"): K2tc3's kernel fed by the ragged-row
    producer. Same contract as `streaming_topk_cuda_tc3`, for any rows."""
    return _tensor_core_scan(q, x, bias, k, tile_n, (torch.float32,), _launch_tc,
                             streaming_topk_cuda_tc3_ragged, ragged=True)


def _tc_route(q: torch.Tensor, x: torch.Tensor):
    """K2's and K3's wrapper over bf16 rows for q's dtype and x's route."""
    if flat_route(x) == "tma":
        return streaming_topk_cuda_tc if q.dtype == torch.bfloat16 else streaming_topk_cuda_tc3
    return (streaming_topk_cuda_tc_ragged if q.dtype == torch.bfloat16
            else streaming_topk_cuda_tc3_ragged)


def _f32_pieces_scan(q, x, bias, k, tile_n, launch, counted, xt=False):
    """K1r's, K2r's and (xt: x is xt [D, N]) K4r's body: the plain version
    on CPU tensors; on CUDA tensors its kernel over f32 rows in 4-byte
    pieces (or a raise), counted in `counted.launches`."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x.T if xt else x, bias, k, tile_n)
    (_check_xt if xt else _check)(q, x, bias, k)
    if x.dtype != torch.float32:
        raise ValueError(f"the 4-byte-piece kernels read f32 rows, got x {x.dtype}")
    out = launch(q, x, bias, k)
    with _count_lock:
        counted.launches += 1
    return out


def streaming_topk_cuda_ragged(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 over f32 rows in 4-byte pieces ("K1r": `topk_ragged_pass1`, K1's
    column warps, tile and pass 2), for rows 16-byte pieces cannot read (D
    % 4 != 0, or a base not 16-byte aligned); it takes any f32 rows. CPU
    tensors run `streaming_topk`; CUDA tensors launch the kernel or raise."""
    return _f32_pieces_scan(q, x, bias, k, tile_n,
                            lambda q_, x_, b_, k_: _launch_col(q_, x_, b_, k_, k1_tm(q_.shape[0]),
                                                               piece=4),
                            streaming_topk_cuda_ragged)


def streaming_topk_cuda_qmajor_ragged(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 and K3 over f32 rows in 4-byte pieces ("K2r": `rows_pass1<float,
    false, QT, 4>`, K2's row tiles, ring and pass 2), for rows 16-byte
    pieces cannot read; it takes any f32 rows. Same contract as
    `streaming_topk_cuda_ragged`."""
    return _f32_pieces_scan(q, x, bias, k, tile_n,
                            lambda q_, x_, b_, k_: _launch_rows(q_, x_, b_, k_, K2_LAYOUT,
                                                                piece=4),
                            streaming_topk_cuda_qmajor_ragged)


def streaming_topk_cuda_tc_xt(
    q: torch.Tensor, xt: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 over bf16 queries and a bf16 xt [D, N] ("K4tc"): K2tc's kernel
    and plan with each stage's corpus read from xt as two MN-major boxes
    (`wgmma` with the B operand transposed). Its results equal K2tc's on
    xt.T. CPU tensors run `streaming_topk` on xt.T; CUDA tensors launch
    the kernel, which takes bf16 q and xt only, any D, N % 8 == 0 and a
    16-byte aligned xt (`xt_tma_readable`), or raise."""
    return _tensor_core_scan(q, xt, bias, k, tile_n, (torch.bfloat16,), _launch_tc_xt,
                             streaming_topk_cuda_tc_xt, xt=True)


def streaming_topk_cuda_tc3_xt(
    q: torch.Tensor, xt: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 over f32 queries and a bf16 xt [D, N] ("K4tc3"): K4tc's kernel
    with each f32 query as its three bf16 pieces (`split_bf16`), as K2tc3.
    Same contract as `streaming_topk_cuda_tc_xt`, for f32 q."""
    return _tensor_core_scan(q, xt, bias, k, tile_n, (torch.float32,), _launch_tc_xt,
                             streaming_topk_cuda_tc3_xt, xt=True)


def streaming_topk_cuda_tc_xt_ragged(
    q: torch.Tensor, xt: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 over bf16 queries and a bf16 xt [D, N] of any N and base
    ("K4tcr"): K4tc's kernel with the two MN-major boxes of each stage
    written by the ragged-row producer (csrc/hopper_tc.cuh: cp.async pieces
    of `load_piece(2N, addr)` bytes, or realigned words; `swizzled_xt_stage`
    models a stage), zeros past N and D; the queries still come by TMA. K4
    sends it every bf16 xt that TMA cannot read; it takes any. Same
    contract as `streaming_topk_cuda_tc_xt`, for any xt."""
    return _tensor_core_scan(q, xt, bias, k, tile_n, (torch.bfloat16,), _launch_tc_xt,
                             streaming_topk_cuda_tc_xt_ragged, xt=True, ragged=True)


def streaming_topk_cuda_tc3_xt_ragged(
    q: torch.Tensor, xt: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 over f32 queries (three bf16 pieces) and a bf16 xt of any N and
    base ("K4tc3r"): K4tc3's kernel fed by the ragged-row producer. Same
    contract as `streaming_topk_cuda_tc3_xt`, for any xt."""
    return _tensor_core_scan(q, xt, bias, k, tile_n, (torch.float32,), _launch_tc_xt,
                             streaming_topk_cuda_tc3_xt_ragged, xt=True, ragged=True)


def _tc_xt_route(q: torch.Tensor, xt: torch.Tensor):
    """K4's wrapper over a bf16 xt for q's dtype and xt's shape and base:
    TMA's instance where `xt_tma_readable`, else the ragged-row
    producer's."""
    if flat_route(xt) == "tma":
        return streaming_topk_cuda_tc_xt if q.dtype == torch.bfloat16 else \
            streaming_topk_cuda_tc3_xt
    return (streaming_topk_cuda_tc_xt_ragged if q.dtype == torch.bfloat16
            else streaming_topk_cuda_tc3_xt_ragged)


def _check_xt(q: torch.Tensor, xt: torch.Tensor, bias: torch.Tensor, k: int) -> None:
    """`_check` for a corpus xt [D, N]: no condition on D, N or alignment
    beyond the element's (`flat_route` of xt: `rows_pass1` reads an f32 xt
    along N in 16- or 4-byte pieces; a bf16 xt runs on the tensor cores,
    through TMA or the ragged-row producer)."""
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
    if xt.data_ptr() % xt.element_size() or bias.data_ptr() % 4:
        raise ValueError("xt and bias must be aligned to their element size")
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
    A bf16 xt runs on the tensor cores (`uses_tensor_cores`), each route
    counting in its own launches: where TMA can read it
    (`xt_tma_readable`) bf16 queries as `streaming_topk_cuda_tc_xt`
    ("K4tc") and f32 queries as `streaming_topk_cuda_tc3_xt` ("K4tc3"),
    any other bf16 xt as their `_ragged` forms ("K4tcr", "K4tc3r"); an f32
    xt launches `rows_pass1` in 16-byte pieces and counts here, or, where
    `flat_route` of xt says "4-byte pieces", runs
    `streaming_topk_cuda_qmajor_xt_ragged` ("K4r"). Returns (scores [B, k]
    f32, ids [B, k] int32)."""
    if _on_cpu(q, xt, bias):
        return streaming_topk(q, xt.T, bias, k, tile_n)
    _check_xt(q, xt, bias, k)
    if uses_tensor_cores(q.dtype, xt.dtype):
        return _tc_xt_route(q, xt)(q, xt, bias, k, tile_n)
    if flat_route(xt) != PIECE_NAMES[16]:
        return streaming_topk_cuda_qmajor_xt_ragged(q, xt, bias, k, tile_n)
    out = _launch_rows(q, xt, bias, k, K4_LAYOUT)
    with _count_lock:
        streaming_topk_cuda_qmajor_xt.launches += 1
    return out


def streaming_topk_cuda_qmajor_xt_ragged(
    q: torch.Tensor, xt: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 over an f32 xt [D, N] in 4-byte pieces ("K4r": `rows_pass1<float,
    true, QT, 4>`, K4's row tiles, ring and pass 2, each thread's pieces
    asynchronous copies into the ring), for an xt that 16-byte pieces
    cannot read (N % 4 != 0, or a base not 16-byte aligned); it takes any
    f32 xt. CPU tensors run `streaming_topk` on xt.T; CUDA tensors launch
    the kernel or raise."""
    return _f32_pieces_scan(q, xt, bias, k, tile_n,
                            lambda q_, x_, b_, k_: _launch_rows(q_, x_, b_, k_, K4_LAYOUT,
                                                                piece=4),
                            streaming_topk_cuda_qmajor_xt_ragged, xt=True)


streaming_topk_cuda.launches = 0
streaming_topk_cuda_qmajor.launches = 0
streaming_topk_cuda_qres.launches = 0
streaming_topk_cuda_qmajor_xt.launches = 0
streaming_topk_cuda_tc.launches = 0
streaming_topk_cuda_tc3.launches = 0
streaming_topk_cuda_k1tc.launches = 0
streaming_topk_cuda_tc_xt.launches = 0
streaming_topk_cuda_tc3_xt.launches = 0
streaming_topk_cuda_ragged.launches = 0
streaming_topk_cuda_qmajor_ragged.launches = 0
streaming_topk_cuda_qmajor_xt_ragged.launches = 0
streaming_topk_cuda_k1tc_ragged.launches = 0
streaming_topk_cuda_tc_ragged.launches = 0
streaming_topk_cuda_tc3_ragged.launches = 0
streaming_topk_cuda_tc_xt_ragged.launches = 0
streaming_topk_cuda_tc3_xt_ragged.launches = 0


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
    "streaming_topk_cuda_tc_xt",
    "streaming_topk_cuda_tc3_xt",
    "streaming_topk_cuda_ragged",
    "streaming_topk_cuda_qmajor_ragged",
    "streaming_topk_cuda_qmajor_xt_ragged",
    "streaming_topk_cuda_k1tc_ragged",
    "streaming_topk_cuda_tc_ragged",
    "streaming_topk_cuda_tc3_ragged",
    "streaming_topk_cuda_tc_xt_ragged",
    "streaming_topk_cuda_tc3_xt_ragged",
    "flat_route",
    "load_piece",
    "rows_tma_readable",
    "swizzled_box",
    "swizzled_xt_stage",
    "k1tc_plan",
    "tc_plan",
    "uses_tensor_cores",
    "xt_tma_readable",
]

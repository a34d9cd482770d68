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
  (K2, large batches), `streaming_topk_cuda_qres` (K3, K2 with each
  block's query tile resident in shared memory) and
  `streaming_topk_cuda_qmajor_xt` (K4, K2 over a pre-transposed corpus
  xt [D, N]; no index calls it) launch the hand-written kernel in
  `csrc/flat_topk.cu` on CUDA tensors, and run `streaming_topk` on CPU
  tensors. On a CUDA tensor they launch or raise; nothing falls back.

Order and sentinels, shared by every version: a higher score wins; on
equal scores the lower row id wins. The running top-k starts as
(NEG_INF, -1), so rows scoring NEG_INF or lower (tombstones) never enter
and rows past the live count come out as (NEG_INF, -1).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

DEFAULT_TILE_N = 1024
MAX_K = 1024

#: pass-1 layouts of csrc/flat_topk.cu: K1 = column warps (the 8 warps
#: share up to 8 query rows and split a 256-row corpus tile), K2 = row
#: warps (8 groups of tm query rows over a 128-row corpus tile), K3 = row
#: warps whose query tile stays resident in shared memory for the block's
#: whole corpus split. csrc/int8_topk.cu numbers K5/K6/K7 the same way,
#: with the same corpus tiles and query tiles of tm or 8 * tm rows. K4 =
#: K2's row warps reading the corpus from xt [D, N].
K1_LAYOUT, K2_LAYOUT, K3_LAYOUT, K4_LAYOUT = 0, 1, 2, 3
CORPUS_TILE = {K1_LAYOUT: 256, K2_LAYOUT: 128, K3_LAYOUT: 128, K4_LAYOUT: 128}
#: K2 takes the largest tm (query tile 8 * tm) whose top-k lists fit
#: K2_SMEM_BYTES of shared memory. Larger tm means fewer shared-memory
#: reads per FMA, but above ~112 KB a block holds an SM alone, and for
#: k=300 that lost more than the reads gained (PERF.md)
K2_TMS = (16, 8, 4, 2, 1)
K2_SMEM_BYTES = 112 * 1024
#: pass 1 aims at this many blocks per kernel (4 or 2 per SM of an H100);
#: pass 2 merges MERGE_GROUP per-split lists per warp and level
TARGET_BLOCKS = {K1_LAYOUT: 4 * 132, K2_LAYOUT: 2 * 132, K3_LAYOUT: 2 * 132,
                 K4_LAYOUT: 2 * 132}
MERGE_GROUP = 16


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
# K1 / K2 / K3: hand-written CUDA kernel (csrc/flat_topk.cu)
# ---------------------------------------------------------------------------

_lib_handle = None
_count_lock = threading.Lock()


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from codegraph_tpu_torch.ops import cuda_build

        lib = cuda_build.load("flat_topk")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flat_topk.argtypes = [p, p, i, p, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
        lib.flat_topk.restype = i
        lib.flat_topk_pass1_smem.argtypes = [i, i, i, i]
        lib.flat_topk_pass1_smem.restype = ll
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


def _launch(q, x, bias, k: int, layout: int, tm: int):
    lib = _lib()
    B, D = q.shape
    N = x.shape[1] if layout == K4_LAYOUT else x.shape[0]
    q = q.float().contiguous()  # bf16 queries widen exactly
    splits, rows = _plan(B, N, layout, query_tile(layout, tm))
    out_s = torch.empty((B, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((B, k), dtype=torch.int32, device=q.device)
    n_work = max(1, lib.flat_topk_work_entries(B, k, splits, MERGE_GROUP))
    work_s = torch.empty((n_work,), dtype=torch.float32, device=q.device)
    work_i = torch.empty((n_work,), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flat_topk(
        q.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16), bias.data_ptr(),
        B, N, D, k, layout, tm, splits, rows, MERGE_GROUP,
        out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"flat_topk kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, layout={layout}, tm={tm})")
    return out_s, out_i


def k1_tm(B: int) -> int:
    """K1's query rows per block: B rounded up to 1, 2, 4 or 8."""
    return next(tm for tm in (1, 2, 4, 8) if tm >= min(B, 8))


def query_tile(layout: int, tm: int) -> int:
    """Query rows per block: tm for column warps, 8 * tm for row warps."""
    return tm if layout == K1_LAYOUT else 8 * tm


def row_warps_tm(pass1_smem, layout: int, B: int, k: int, D: int, tms=K2_TMS,
                 budget: int = K2_SMEM_BYTES) -> int:
    """Micro-tile rows of a row-tile layout (query tile 8 * tm): the
    largest of `tms` whose pass-1 shared memory (`pass1_smem(layout, tm,
    k, D)`: lists, operand tiles and, for a resident query tile, the tile)
    fits `budget`, and no larger than the batch needs; the smallest when
    none fits (the launch then reports it)."""
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
    multiple of 8. Returns (scores [B, k] f32, ids [B, k] int32)."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x, bias, k, tile_n)
    _check(q, x, bias, k)
    out = _launch(q, x, bias, k, K1_LAYOUT, k1_tm(q.shape[0]))
    with _count_lock:
        streaming_topk_cuda.launches += 1
    return out


def streaming_topk_cuda_qmajor(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: exact top-k for large query batches (up to 64-row query tiles,
    so each corpus tile read serves many queries). Same contract as
    `streaming_topk_cuda`."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x, bias, k, tile_n)
    _check(q, x, bias, k)
    B, D = q.shape
    tm = row_warps_tm(_lib().flat_topk_pass1_smem, K2_LAYOUT, B, k, D)
    out = _launch(q, x, bias, k, K2_LAYOUT, tm)
    with _count_lock:
        streaming_topk_cuda_qmajor.launches += 1
    return out


def streaming_topk_cuda_qres(
    q: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: K2 with each block's query tile resident in shared memory for
    its whole corpus split, so that only the corpus streams (the resident
    tile costs shared memory, so it is smaller than K2's at large D).
    Same contract as `streaming_topk_cuda`."""
    if _on_cpu(q, x, bias):
        return streaming_topk(q, x, bias, k, tile_n)
    _check(q, x, bias, k)
    B, D = q.shape
    tm = row_warps_tm(_lib().flat_topk_pass1_smem, K3_LAYOUT, B, k, D)
    out = _launch(q, x, bias, k, K3_LAYOUT, tm)
    with _count_lock:
        streaming_topk_cuda_qres.launches += 1
    return out


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
    B, D = q.shape
    tm = row_warps_tm(_lib().flat_topk_pass1_smem, K4_LAYOUT, B, k, D)
    out = _launch(q, xt, bias, k, K4_LAYOUT, tm)
    with _count_lock:
        streaming_topk_cuda_qmajor_xt.launches += 1
    return out


streaming_topk_cuda.launches = 0
streaming_topk_cuda_qmajor.launches = 0
streaming_topk_cuda_qres.launches = 0
streaming_topk_cuda_qmajor_xt.launches = 0


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
]

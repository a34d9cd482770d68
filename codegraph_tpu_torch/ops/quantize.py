"""int8 quantization for the flat-scan tier.

Port of `codegraph_tpu/ops/quantize.py`: per-row symmetric int8, so that

    score[b, n] = (v[b] . u[n]) * t[b] * s[n] + bias[n]

where `v . u` is an exact int8 x int8 -> int32 dot product and the scales
fold in afterwards; recall is recovered by a high-precision rescore of the
top candidates (`rescore_topk`).

* `quantize_rows`, `dequantize_rows`, `int8_scores`, `streaming_topk_int8`
  and `rescore_topk` are plain PyTorch, with the reference's op order.
  `streaming_topk_int8` is what the kernels are held to.
* `streaming_topk_int8_cuda` (K5, small batches, `__dp4a`),
  `streaming_topk_int8_cuda_qmajor` (K6, large batches, `wgmma` fed by
  TMA) and `streaming_topk_int8_cuda_qres` (K7, which runs K6's schedule:
  its resident query tile is that schedule's design) launch the
  hand-written kernels in `csrc/int8_topk.cu` on CUDA tensors and run
  `streaming_topk_int8` on CPU tensors. They take any width D, as the JAX
  kernels do (`int8_route` says how rows are read): K6 and K7 send a
  corpus TMA cannot read (`tma_shape`) to `streaming_topk_int8_cuda_ragged`
  ("K6r": the same `wgmma` kernel with its corpus brought by the
  ragged-row producer of `csrc/hopper_tc.cuh`), and K5 rows that are not
  4-byte aligned (D % 4 != 0, or a base one byte in) to
  `streaming_topk_int8_cuda_realigned` ("K5r"). On a CUDA tensor they
  launch or raise; nothing falls back. `tc_plan` is the host-side plan of
  K6/K7.

The int8 dot product must be exact. `torch.mm` of two int8 tensors returns
int8 and wraps, so the plain version widens first: to int32 on the CPU; on
CUDA (no int32 matmul in cuBLAS) to f32 with TF32 off, exact while
D * 127^2 < 2^24 (D <= 1040), and to f64 above that.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

from codegraph_tpu_torch.ops.topk import (
    K1_LAYOUT,
    MAX_K,
    MERGE_GROUP,
    NEG_INF,
    PIECE_NAMES,
    ROW_CAP,  # ROW_CAP, SMEM_PER_BLOCK and TC_*: the shared plan's, for tc_plan's callers
    SMEM_PER_BLOCK,
    TC_BUF_CAP,
    TC_SMS,
    TC_STAGES,
    TC_TILE_N,
    _on_cpu,
    _outputs,
    _plan,
    _sort_desc,
    k1_tm,
    load_piece,
    merge_topk,
)
from codegraph_tpu_torch.ops.topk import tc_plan as topk_tc_plan
from codegraph_tpu_torch.ops.topk import tc_smem as topk_tc_smem

INT8_MAX = 127.0
DEFAULT_TILE_N = 2048
#: the largest D whose int8 dot products an f32 matmul sums exactly
#: (|q . x| <= D * 127^2 < 2^24)
F32_EXACT_MAX_D = (2**24 - 1) // (127 * 127)


def quantize_rows(x: torch.Tensor, eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 quantization.

    x: [N, D] float. Returns (q [N, D] int8, scales [N] f32) with
    x ~= scales[:, None] * q. Zero rows get scale 0. `round` is half to
    even, as in the reference.
    """
    x = x.float()
    absmax = x.abs().amax(dim=-1)
    scales = absmax / INT8_MAX
    inv = torch.where(scales > eps, 1.0 / torch.clamp(scales, min=eps), torch.zeros_like(scales))
    q = torch.clamp(torch.round(x * inv[:, None]), -INT8_MAX, INT8_MAX).to(torch.int8)
    return q, scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_rows: [N, D] int8 + [N] f32 -> [N, D] f32."""
    return q.float() * scales[:, None]


def int8_dot(qv: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """[B, D] int8 x [N, D] int8 -> [B, N] f32 holding the exact int32 dot
    products, rounded to f32 as the reference's `raw.astype(f32)`."""
    if qv.device.type == "cpu":
        return (qv.int() @ xv.int().T).float()
    if qv.shape[1] <= F32_EXACT_MAX_D:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("int8_dot sums int8 products in an f32 matmul, which is exact "
                               "only with torch.backends.cuda.matmul.allow_tf32 = False")
        return qv.float() @ xv.float().T
    return (qv.double() @ xv.double().T).float()


def int8_scores(qv: torch.Tensor, qs: torch.Tensor, xv: torch.Tensor,
                xs: torch.Tensor) -> torch.Tensor:
    """Scaled int8 score tile: [B, D] i8 x [N, D] i8 -> [B, N] f32, as
    `raw.float() * qs[:, None] * xs[None, :]` (two roundings, in order)."""
    return int8_dot(qv, xv) * qs[:, None] * xs[None, :]


def streaming_topk_int8(
    qv: torch.Tensor,
    qs: torch.Tensor,
    xv: torch.Tensor,
    xs: torch.Tensor,
    bias: torch.Tensor,
    k: int,
    tile_n: int = DEFAULT_TILE_N,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain streaming top-k over an int8 corpus (the XLA scan of the JAX
    package): loop over row tiles of xv, carrying the running top-k.

    qv/qs: quantized queries [B, D] int8 + scales [B]; xv/xs: quantized
    corpus [N, D] int8 (any N) + scales [N]; bias [N] f32, 0 live /
    NEG_INF dead. Returns (scores [B, k] f32, ids [B, k] int32).
    """
    B = qv.shape[0]
    top_s = torch.full((B, k), NEG_INF, dtype=torch.float32, device=qv.device)
    top_i = torch.full((B, k), -1, dtype=torch.int32, device=qv.device)
    for base in range(0, xv.shape[0], tile_n):
        end = min(base + tile_n, xv.shape[0])
        s = int8_scores(qv, qs, xv[base:end], xs[base:end]) + bias[base:end][None, :]
        ids = torch.arange(base, end, dtype=torch.int32, device=qv.device).expand(B, -1)
        top_s, top_i = merge_topk(top_s, top_i, s, ids, k)
    return top_s, top_i


def rescore_topk(
    q: torch.Tensor,
    x_rescore: torch.Tensor,
    cand_ids: torch.Tensor,
    cand_scores: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 rescore of quantized-scan candidates (the reference's stage 2).

    q: [B, D] f32 queries; x_rescore: [cap, D] high-precision corpus;
    cand_ids/cand_scores: [B, C] from the int8 scan (ids may be -1).
    Gathers the candidate rows, recomputes exact dot scores and returns
    their top-k; a tie keeps the scan's order, as `lax.top_k` does.
    """
    rows = x_rescore[cand_ids.clamp_min(0).long()].float()  # [B, C, D]
    exact = torch.bmm(rows, q.float()[:, :, None])[:, :, 0]
    exact = torch.where(cand_ids >= 0, exact, torch.full_like(exact, NEG_INF))
    return _sort_desc(exact, cand_ids, k)


# ---------------------------------------------------------------------------
# K5 / K6 / K7: hand-written CUDA kernel (csrc/int8_topk.cu)
# ---------------------------------------------------------------------------

_lib_handle = None
_count_lock = threading.Lock()


def _lib():
    global _lib_handle
    if _lib_handle is None:
        from codegraph_tpu_torch.ops import cuda_build

        lib = cuda_build.load("int8_topk")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.int8_topk.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p, p, p, p, p]
        lib.int8_topk.restype = i
        lib.int8_topk_tc.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, ll, i, i,
                                     p, p, p, p, p, p, p, p]
        lib.int8_topk_tc.restype = i
        lib.int8_topk_tc_cand_entries.argtypes = [i, i, i]
        lib.int8_topk_tc_cand_entries.restype = ll
        lib.int8_topk_tc_smem.argtypes = [i, i, i, i]
        lib.int8_topk_tc_smem.restype = ll
        lib.int8_topk_work_entries.argtypes = [i, i, i, i]
        lib.int8_topk_work_entries.restype = ll
        _lib_handle = lib
    return _lib_handle


def _check(qv, qs, xv, xs, bias, k: int) -> None:
    if qv.dim() != 2 or xv.dim() != 2 or qs.dim() != 1 or xs.dim() != 1 or bias.dim() != 1:
        raise ValueError("expected qv [B, D], qs [B], xv [N, D], xs [N], bias [N]")
    B, D = qv.shape
    N = xv.shape[0]
    if xv.shape[1] != D or qs.shape[0] != B or xs.shape[0] != N or bias.shape[0] != N:
        raise ValueError(f"shape mismatch: qv {tuple(qv.shape)}, qs {tuple(qs.shape)}, "
                         f"xv {tuple(xv.shape)}, xs {tuple(xs.shape)}, bias {tuple(bias.shape)}")
    if B < 1 or N < 1:
        raise ValueError("empty query batch or corpus")
    if qv.dtype != torch.int8 or xv.dtype != torch.int8:
        raise ValueError(f"qv and xv must be int8, got {qv.dtype} and {xv.dtype}")
    if qs.dtype != torch.float32 or xs.dtype != torch.float32 or bias.dtype != torch.float32:
        raise ValueError("qs, xs and bias must be float32")
    if not all(t.is_contiguous() for t in (qv, qs, xv, xs, bias)):
        raise ValueError("qv, qs, xv, xs and bias must be contiguous")
    if any(t.data_ptr() % 4 for t in (qs, xs, bias)):
        raise ValueError("qs, xs and bias must be aligned to their element size")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    if N >= 2**31 - 1024 or xv.numel() >= 2**62:
        raise ValueError("corpus too large for 32-bit row ids")


def tma_shape(qv: torch.Tensor, xv: torch.Tensor, xs: torch.Tensor,
              bias: torch.Tensor) -> bool:
    """The shape rule of K6/K7: TMA reads rows whose byte stride is a
    multiple of 16 from 16-byte aligned addresses (the rows qv and xv, and
    the corpus scales xs and bias), so `int8_tc_pass1` takes D % 16 == 0
    with all four 16-byte aligned; every other shape goes to the same
    kernel fed by the ragged-row producer (`streaming_topk_int8_cuda_ragged`,
    "K6r")."""
    return qv.shape[1] % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (qv, xv, xs, bias))


def int8_route(kernel: str, qv: torch.Tensor, xv: torch.Tensor, xs: torch.Tensor,
               bias: torch.Tensor) -> str:
    """How `kernel` ("K5", or "K6"/"K7") reads the int8 rows xv [N, D] on a
    card, from D and the addresses: K5 "4-byte pieces" (its words) or
    "bytes" (K5r: the aligned words that hold each, realigned); K6/K7
    "tma" or "ragged, <piece>" (K6r: the ragged-row producer's copies,
    `load_piece`). Every width and address torch hands over takes one."""
    D, addr = xv.shape[1], xv.data_ptr()
    if kernel == "K5":
        return PIECE_NAMES[4] if D % 4 == 0 and addr % 4 == 0 else PIECE_NAMES[1]
    if tma_shape(qv, xv, xs, bias):
        return "tma"
    return "ragged, " + PIECE_NAMES[load_piece(D, addr)]


#: K6/K7 on wgmma (csrc/int8_topk.cu `int8_tc_pass1`) share K2tc's block
#: design, constants and plan (ops/topk.py): int8 operands (1 byte an
#: element) and a corpus scale beside each row's bias (8 meta bytes a row)
tc_smem = functools.partial(topk_tc_smem, elt=1, meta=8)
tc_plan = functools.partial(topk_tc_plan, elt=1, meta=8)


def _padded_queries(qv: torch.Tensor, multiple: int) -> torch.Tensor:
    """qv [B, D] with zero columns up to a multiple of `multiple` and a
    16-byte aligned base (the B x D queries are padded, never the
    corpus)."""
    if qv.shape[1] % multiple:
        qv = torch.nn.functional.pad(qv, (0, multiple - qv.shape[1] % multiple))
    return qv if qv.data_ptr() % 16 == 0 else qv.clone()


def _launch(qv, qs, xv, xs, bias, k: int, tm: int, piece: int):
    """K5: __dp4a column warps with tm query rows a block, the rows read as
    words (piece 4) or realigned from the words that hold them (piece 1:
    K5r); qv goes as words, zero-padded to a multiple of 4 columns."""
    lib = _lib()
    B, D = qv.shape
    N = xv.shape[0]
    qv = _padded_queries(qv, 4)
    splits, rows = _plan(B, N, K1_LAYOUT, tm)
    out_s, out_i, work_s, work_i = _outputs(
        B, k, lib.int8_topk_work_entries(B, k, splits, MERGE_GROUP), qv.device)
    stream = torch.cuda.current_stream(qv.device).cuda_stream
    err = lib.int8_topk(
        qv.data_ptr(), qs.data_ptr(), xv.data_ptr(), xs.data_ptr(), bias.data_ptr(),
        B, N, D, k, tm, splits, rows, MERGE_GROUP, piece,
        out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_topk kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, tm={tm}, piece={piece})")
    return out_s, out_i


def _launch_tc(qv, qs, xv, xs, bias, k: int, ragged: bool = False):
    """K6/K7 (K6r: ragged): `int8_tc_pass1` as `tc_plan` lays it out, then
    pass 2. The ragged instance reads the corpus in `load_piece` copies
    and takes qv padded to a multiple of 16 columns (TMA still reads it)."""
    lib = _lib()
    B, D = qv.shape
    N = xv.shape[0]
    piece = load_piece(D, xv.data_ptr()) if ragged else 0
    if ragged:
        qv = _padded_queries(qv, 16)
    plan = tc_plan(B, N, D, k, sms=torch.cuda.get_device_properties(qv.device).multi_processor_count)
    if lib.int8_topk_tc_smem(plan.query_tile, int(plan.resident), plan.stages, D) != plan.smem \
            or lib.int8_topk_work_entries(B, k, plan.splits, MERGE_GROUP) != plan.work_entries or \
            lib.int8_topk_tc_cand_entries(B, plan.query_tile, plan.splits) != plan.cand_entries:
        raise RuntimeError("ops/quantize.py tc_plan disagrees with csrc/int8_topk.cu")
    out_s, out_i, work_s, work_i = _outputs(B, k, plan.work_entries, qv.device)
    bound = torch.full((plan.bound_entries,), NEG_INF, dtype=torch.float32, device=qv.device)
    cand_s = torch.empty((plan.cand_entries,), dtype=torch.float32, device=qv.device)
    cand_i = torch.empty((plan.cand_entries,), dtype=torch.int32, device=qv.device)
    stream = torch.cuda.current_stream(qv.device).cuda_stream
    err = lib.int8_topk_tc(
        qv.data_ptr(), qs.data_ptr(), xv.data_ptr(), xs.data_ptr(), bias.data_ptr(),
        B, N, D, k, plan.query_tile, int(plan.resident), plan.stages,
        plan.splits, plan.rows_per_split, plan.smem, MERGE_GROUP, piece,
        out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(),
        bound.data_ptr(), cand_s.data_ptr(), cand_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_topk_tc kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, piece={piece}, {plan})")
    return out_s, out_i


def streaming_topk_int8_cuda(qv, qs, xv, xs, bias, k: int, tile_n: int = DEFAULT_TILE_N):
    """K5: exact int8 top-k for small query batches (query tiles of up to 8
    rows, corpus split across blocks). CPU tensors run
    `streaming_topk_int8` (tile_n is its tile); CUDA tensors launch the
    kernel at any D: rows that are not 4-byte aligned (D % 4 != 0, or a
    base one byte in) run `streaming_topk_int8_cuda_realigned` ("K5r") and
    count there. Returns (scores [B, k] f32, ids [B, k] int32)."""
    if _on_cpu(qv, qs, xv, xs, bias):
        return streaming_topk_int8(qv, qs, xv, xs, bias, k, tile_n)
    _check(qv, qs, xv, xs, bias, k)
    if int8_route("K5", qv, xv, xs, bias) != PIECE_NAMES[4]:
        return streaming_topk_int8_cuda_realigned(qv, qs, xv, xs, bias, k, tile_n)
    out = _launch(qv, qs, xv, xs, bias, k, k1_tm(qv.shape[0]), 4)
    with _count_lock:
        streaming_topk_int8_cuda.launches += 1
    return out


def streaming_topk_int8_cuda_qmajor(qv, qs, xv, xs, bias, k: int,
                                    tile_n: int = DEFAULT_TILE_N):
    """K6: exact int8 top-k for large query batches on the tensor cores
    (`wgmma` s8 with TMA-fed operands; 128-row query tiles, or a 64-row
    tile for a batch of at most 64; the top-k lists in device memory behind
    a per-row threshold and candidate buffer, so every k takes the same
    tile). Shape rule (`tma_shape`): D % 16 == 0 with qv and xv 16-byte
    aligned and xs and bias 16-byte aligned runs `int8_tc_pass1`; any other
    shape runs the same kernel fed by the ragged-row producer ("K6r") and
    counts in `streaming_topk_int8_cuda_ragged.launches`. Same contract as
    `streaming_topk_int8_cuda`."""
    if _on_cpu(qv, qs, xv, xs, bias):
        return streaming_topk_int8(qv, qs, xv, xs, bias, k, tile_n)
    _check(qv, qs, xv, xs, bias, k)
    if not tma_shape(qv, xv, xs, bias):
        return streaming_topk_int8_cuda_ragged(qv, qs, xv, xs, bias, k, tile_n)
    out = _launch_tc(qv, qs, xv, xs, bias, k)
    with _count_lock:
        streaming_topk_int8_cuda_qmajor.launches += 1
    return out


def streaming_topk_int8_cuda_qres(qv, qs, xv, xs, bias, k: int,
                                  tile_n: int = DEFAULT_TILE_N):
    """K7: exact int8 top-k with each block's query tile resident while the
    corpus streams past it. That is K6's schedule on Hopper, so K7 runs
    it, with the same shape rule, and counts its own launches. Same
    contract as `streaming_topk_int8_cuda`."""
    if _on_cpu(qv, qs, xv, xs, bias):
        return streaming_topk_int8(qv, qs, xv, xs, bias, k, tile_n)
    _check(qv, qs, xv, xs, bias, k)
    if not tma_shape(qv, xv, xs, bias):
        return streaming_topk_int8_cuda_ragged(qv, qs, xv, xs, bias, k, tile_n)
    out = _launch_tc(qv, qs, xv, xs, bias, k)
    with _count_lock:
        streaming_topk_int8_cuda_qres.launches += 1
    return out


def streaming_topk_int8_cuda_ragged(qv, qs, xv, xs, bias, k: int,
                                    tile_n: int = DEFAULT_TILE_N):
    """K6/K7 over a corpus of any width and base ("K6r"): `int8_tc_pass1`'s
    `wgmma` schedule, plan, epilogue and flush, with its corpus boxes and
    the tiles' scales and bias brought by the producer warp's own copies
    (csrc/hopper_tc.cuh's ragged-row producer: cp.async pieces of
    `load_piece` bytes, or realigned words), laid out as TMA's boxes; qv,
    padded to a multiple of 16 columns, still comes by TMA. K6 and K7 send
    it what `tma_shape` rejects; it takes any shape. Scores bit for bit
    the plain version's. Same contract as `streaming_topk_int8_cuda`."""
    if _on_cpu(qv, qs, xv, xs, bias):
        return streaming_topk_int8(qv, qs, xv, xs, bias, k, tile_n)
    _check(qv, qs, xv, xs, bias, k)
    out = _launch_tc(qv, qs, xv, xs, bias, k, ragged=True)
    with _count_lock:
        streaming_topk_int8_cuda_ragged.launches += 1
    return out


def streaming_topk_int8_cuda_realigned(qv, qs, xv, xs, bias, k: int,
                                       tile_n: int = DEFAULT_TILE_N):
    """K5 over rows that are not 4-byte aligned ("K5r": D % 4 != 0, or a
    base one byte in): `int8_dp4a_ragged_pass1`, K5's kernel reading the
    aligned words that hold each row (one load a word, one pointer a warp's
    rows) and realigning them in its dot products; the queries' zero
    columns past D cancel the bytes beyond a row. It takes any rows. Same
    contract as `streaming_topk_int8_cuda`."""
    if _on_cpu(qv, qs, xv, xs, bias):
        return streaming_topk_int8(qv, qs, xv, xs, bias, k, tile_n)
    _check(qv, qs, xv, xs, bias, k)
    out = _launch(qv, qs, xv, xs, bias, k, k1_tm(qv.shape[0]), 1)
    with _count_lock:
        streaming_topk_int8_cuda_realigned.launches += 1
    return out


streaming_topk_int8_cuda.launches = 0
streaming_topk_int8_cuda_qmajor.launches = 0
streaming_topk_int8_cuda_qres.launches = 0
streaming_topk_int8_cuda_ragged.launches = 0
streaming_topk_int8_cuda_realigned.launches = 0


__all__ = [
    "INT8_MAX",
    "F32_EXACT_MAX_D",
    "quantize_rows",
    "dequantize_rows",
    "int8_dot",
    "int8_scores",
    "streaming_topk_int8",
    "rescore_topk",
    "streaming_topk_int8_cuda",
    "streaming_topk_int8_cuda_qmajor",
    "streaming_topk_int8_cuda_qres",
    "streaming_topk_int8_cuda_ragged",
    "streaming_topk_int8_cuda_realigned",
    "int8_route",
    "tc_plan",
    "tma_shape",
]

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
  `streaming_topk_int8` on CPU tensors. K6 and K7 send a shape TMA cannot
  take (`tma_shape`) to `streaming_topk_int8_cuda_sync` (`mma.sync`). On
  a CUDA tensor they launch or raise; nothing falls back. `tc_plan` is
  the host-side plan of K6/K7.

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
    K2_LAYOUT,
    MAX_K,
    MERGE_GROUP,
    NEG_INF,
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
    merge_topk,
    query_tile,
    row_warps_tm,
)
from codegraph_tpu_torch.ops.topk import tc_plan as topk_tc_plan
from codegraph_tpu_torch.ops.topk import tc_smem as topk_tc_smem

INT8_MAX = 127.0
DEFAULT_TILE_N = 2048
#: the mma.sync kernel (K6/K7 on shapes TMA cannot take) takes query tiles
#: of 8 * tm rows, tm in MMA_TMS: the largest whose lists, staging tiles
#: and score tile fit MMA_SMEM_BYTES, all the shared memory a block may
#: have on an H100
MMA_TMS = (16, 8, 4, 2)
MMA_SMEM_BYTES = 227 * 1024
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
        lib.int8_topk_tc.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, ll, i,
                                     p, p, p, p, p, p, p, p]
        lib.int8_topk_tc.restype = i
        lib.int8_topk_tc_cand_entries.argtypes = [i, i, i]
        lib.int8_topk_tc_cand_entries.restype = ll
        lib.int8_topk_tc_smem.argtypes = [i, i, i, i]
        lib.int8_topk_tc_smem.restype = ll
        lib.int8_topk_pass1_smem.argtypes = [i, i, i, i]
        lib.int8_topk_pass1_smem.restype = ll
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
    if D % 4 or qv.data_ptr() % 4 or xv.data_ptr() % 4:
        raise ValueError(f"the kernel reads rows as 4-byte words: D={D} must be a multiple "
                         "of 4 and qv, xv 4-byte aligned")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k} outside the kernel's range 1..{MAX_K}")
    if N >= 2**31 - 1024 or xv.numel() >= 2**62:
        raise ValueError("corpus too large for 32-bit row ids")


def tma_shape(qv: torch.Tensor, xv: torch.Tensor, xs: torch.Tensor,
              bias: torch.Tensor) -> bool:
    """The shape rule of K6/K7: TMA reads rows whose byte stride is a
    multiple of 16 from 16-byte aligned addresses (the rows qv and xv, and
    the corpus scales xs and bias), so `int8_tc_pass1` takes D % 16 == 0
    with all four 16-byte aligned; every other shape goes to the mma.sync
    kernel (`streaming_topk_int8_cuda_sync`)."""
    return qv.shape[1] % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in (qv, xv, xs, bias))


#: K6/K7 on wgmma (csrc/int8_topk.cu `int8_tc_pass1`) share K2tc's block
#: design, constants and plan (ops/topk.py): int8 operands (1 byte an
#: element) and a corpus scale beside each row's bias (8 meta bytes a row)
tc_smem = functools.partial(topk_tc_smem, elt=1, meta=8)
tc_plan = functools.partial(topk_tc_plan, elt=1, meta=8)


def _launch(qv, qs, xv, xs, bias, k: int, layout: int, tm: int):
    """K5 (layout 0, __dp4a) or the mma.sync kernel (layout 1)."""
    lib = _lib()
    B, D = qv.shape
    N = xv.shape[0]
    splits, rows = _plan(B, N, layout, query_tile(layout, tm))
    out_s, out_i, work_s, work_i = _outputs(
        B, k, lib.int8_topk_work_entries(B, k, splits, MERGE_GROUP), qv.device)
    stream = torch.cuda.current_stream(qv.device).cuda_stream
    err = lib.int8_topk(
        qv.data_ptr(), qs.data_ptr(), xv.data_ptr(), xs.data_ptr(), bias.data_ptr(),
        B, N, D, k, layout, tm, splits, rows, MERGE_GROUP,
        out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_topk kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, layout={layout}, tm={tm})")
    return out_s, out_i


def _launch_tc(qv, qs, xv, xs, bias, k: int):
    """K6/K7: `int8_tc_pass1` as `tc_plan` lays it out, then pass 2."""
    lib = _lib()
    B, D = qv.shape
    N = xv.shape[0]
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
        plan.splits, plan.rows_per_split, plan.smem, MERGE_GROUP,
        out_s.data_ptr(), out_i.data_ptr(), work_s.data_ptr(), work_i.data_ptr(),
        bound.data_ptr(), cand_s.data_ptr(), cand_i.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"int8_topk_tc kernel launch failed: CUDA error {err} "
                           f"(B={B}, N={N}, D={D}, k={k}, {plan})")
    return out_s, out_i


def streaming_topk_int8_cuda(qv, qs, xv, xs, bias, k: int, tile_n: int = DEFAULT_TILE_N):
    """K5: exact int8 top-k for small query batches (query tiles of up to 8
    rows, corpus split across blocks). CPU tensors run
    `streaming_topk_int8` (tile_n is its tile); CUDA tensors launch the
    kernel, which needs D a multiple of 4. Returns (scores [B, k] f32,
    ids [B, k] int32)."""
    if _on_cpu(qv, qs, xv, xs, bias):
        return streaming_topk_int8(qv, qs, xv, xs, bias, k, tile_n)
    _check(qv, qs, xv, xs, bias, k)
    out = _launch(qv, qs, xv, xs, bias, k, K1_LAYOUT, k1_tm(qv.shape[0]))
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
    shape runs the mma.sync kernel
    and counts in `streaming_topk_int8_cuda_sync.launches`. Same contract
    as `streaming_topk_int8_cuda`."""
    if _on_cpu(qv, qs, xv, xs, bias):
        return streaming_topk_int8(qv, qs, xv, xs, bias, k, tile_n)
    _check(qv, qs, xv, xs, bias, k)
    if not tma_shape(qv, xv, xs, bias):
        return streaming_topk_int8_cuda_sync(qv, qs, xv, xs, bias, k, tile_n)
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
        return streaming_topk_int8_cuda_sync(qv, qs, xv, xs, bias, k, tile_n)
    out = _launch_tc(qv, qs, xv, xs, bias, k)
    with _count_lock:
        streaming_topk_int8_cuda_qres.launches += 1
    return out


def streaming_topk_int8_cuda_sync(qv, qs, xv, xs, bias, k: int,
                                  tile_n: int = DEFAULT_TILE_N):
    """K6/K7 for the shapes TMA cannot take (D % 16 != 0, or rows not
    16-byte aligned): `mma.sync` m16n8k32 s8 on rows staged as 32-bit
    words (D % 4 == 0), query tiles of 16 to 128 rows (`row_warps_tm`),
    lists in shared memory. It takes any shape K5 takes. Same contract as
    `streaming_topk_int8_cuda`."""
    if _on_cpu(qv, qs, xv, xs, bias):
        return streaming_topk_int8(qv, qs, xv, xs, bias, k, tile_n)
    _check(qv, qs, xv, xs, bias, k)
    B, D = qv.shape
    tm = row_warps_tm(_lib().int8_topk_pass1_smem, K2_LAYOUT, B, k, D, MMA_TMS, MMA_SMEM_BYTES)
    out = _launch(qv, qs, xv, xs, bias, k, K2_LAYOUT, tm)
    with _count_lock:
        streaming_topk_int8_cuda_sync.launches += 1
    return out


streaming_topk_int8_cuda.launches = 0
streaming_topk_int8_cuda_qmajor.launches = 0
streaming_topk_int8_cuda_qres.launches = 0
streaming_topk_int8_cuda_sync.launches = 0


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
    "streaming_topk_int8_cuda_sync",
    "tc_plan",
    "tma_shape",
]

#!/usr/bin/env python3
"""Time K6 (`streaming_topk_int8_cuda_qmajor`, csrc/int8_topk.cu
`int8_tc_pass1`) against variants of its design, on one NVIDIA GPU.

    python3 tools/int8_topk_variants.py [--rows 10000000] [--only NAME,NAME]
    python3 tools/int8_topk_variants.py --ragged [--width 760] [--only NAME,NAME]
    python3 tools/int8_topk_variants.py --ragged-k5 [--rows 10000000] [--only NAME,NAME]

With --ragged the timed kernel is K6r (`streaming_topk_int8_cuda_ragged`,
`int8_tc_ragged_pass1`: the ragged-row producer of csrc/hopper_tc.cuh) at
--width (default 768), and the "ragged:" variant runs its producer on one
warp instead of a warpgroup (kRaggedWarps).

With --ragged-k5 the variants are RAGGED_K5_VARIANTS of K5r
(`int8_dp4a_ragged_pass1`: K5 over int8 rows that are not 4-byte
aligned), timed through K5's wrapper at RAGGED_K5_SHAPES (B = 1, 8; k =
100, 300) over 1% tombstoned int8 rows of width 765 beside K5's own
instance (`int8_dp4a_pass1`, words) over rows of width 764, whose code no
variant changes, median ms over 7 batches, all variants in turns; then the
library call (torch._int_mm + topk on a zero-padded copy) at 765. The
variants: the shipped reads (one row pointer a warp, a 33rd aligned word a
row, realigned in the dot products), the loads before them (an address,
two bounds and two loads a word, realigned in registers), one row pointer
with those two loads a word, one row pointer realigned by
__shfl_down_sync as the words are stored, and timing-only ones without
corpus loads, with one aligned load a word at the address rounded down,
and without the 33rd word and the shift. Prints each variant's ptxas lines
for both K5 instances (registers, spills).

Each variant is the committed csrc/int8_topk.cu and csrc/topk_merge.cuh with
its text changes and the tensor-core constants of ops/topk.py (below),
built and loaded in place of the shipped library by tools/variant_harness.py
(into codegraph_tpu_torch/_build/variants_int8/). On a 1% tombstoned
int8 corpus of unit rows at D=768 made on the card from a seed, every
variant runs K6 at B=64, 256 and 1024, k=100 and 300: median ms over 3
batches (CUDA events), all variants in turns, forward then backward.
Variants marked `timing only` give wrong top-k on purpose (they skip the
epilogue, the offer or the merge into the lists); the others are checked against the plain version
on four rows of one batch. Prints the card, each variant's ptxas line for
int8_tc_pass1, and one JSON line per variant. Exits 1 if a variant's text
change no longer applies, a build fails, or a checked variant disagrees.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from codegraph_tpu_torch.ops import quantize, topk  # noqa: E402
from tools import variant_harness as vh  # noqa: E402

EPILOGUE = "      // The epilogue. acc[4j + 2h + e]"
OFFER = "      if (rounds) {"
BOUND_TEST = "s >= lb[h] && beats"
BOUND_THR = "fmaxf(fmaxf(st.thr_s()[sr], st.bnd()[sr]), above_neg_inf)"
FLUSH = "flush_row_inline<kBufCap>(stage_s"
RAGGED_WARPS = "constexpr int kRaggedWarps = 4;"
# name -> (text substitutions, ops/quantize.py constants it changes, checked)
VARIANTS = {
    "shipped": ([], {}, True),
    "products only: no epilogue (timing only)": (
        [(EPILOGUE, "      if (a.k > 0) {  // free the tile's scales and bias\n"
                    "        if (lane == 0) mbar_arrive(meta_empty + 8 * m);\n"
                    "        continue;\n      }\n" + EPILOGUE)], {}, False),
    "no offer: scores and vote only (timing only)": (
        [(OFFER, "      if (rounds && a.k < 0) {")], {}, False),
    "no offer in a list's first tile (timing only)": (
        [(OFFER, "      if (rounds && tile > 0) {")], {}, False),
    "no offer in a list's first 8 tiles (timing only)": (
        [(OFFER, "      if (rounds && tile > 7) {")], {}, False),
    "no shared bound": ([(BOUND_TEST, "beats"), (BOUND_THR, "fmaxf(st.thr_s()[sr], above_neg_inf)")],
                        {}, True),
    "no flush: full buffers emptied unmerged (timing only)": (
        [(FLUSH, "if (k < 0) " + FLUSH)], {}, False),
    "4 ring stages": ([], {"TC_STAGES": (4, 3)}, True),
    "flush at 64 entries": ([("constexpr int kCap = 32;", "constexpr int kCap = 64;")],
                            {"ROW_CAP": 64, "TC_BUF_CAP": 64 + 128}, True),
    "ragged: one producer warp": ([(RAGGED_WARPS, RAGGED_WARPS.replace("= 4;", "= 1;"))], {},
                                  True),
}
SHAPES = ((64, 100), (64, 300), (256, 100), (256, 300), (1024, 100), (1024, 300))
SOURCES = ("int8_topk.cu", "topk_merge.cuh", "hopper_tc.cuh")

# --- K5r: K5 over int8 rows that are not 4-byte aligned (int8_dp4a_ragged_pass1) ---
# the shipped loads of a step: aligned words of rows warp + 8w through one
# row pointer, and aligned word 32 of the thread's own row
K5R_LOADS = """      for (int w = 0; w < XW; ++w) {
        xr[w] = col_ok && 8 * w < rows_left ? (int)__ldg(src) : 0;
        src += stride;
      }
"""
K5R_EXT = """      x_ext = lead_t != 0 && ext < D && n0 + tid < n_end
                  ? (int)__ldg(reinterpret_cast<const uint32_t*>(xa + (size_t)(n0 + tid) * D + ext))
                  : 0;
"""
K5R_EXT_STORE = "    if constexpr (RAGGED) xs[kDKW * XLD + tid] = x_ext;\n"
K5R_SHIFT = "xv = (int)__funnelshift_r((uint32_t)x_lo, (uint32_t)x_hi, 8 * lead_t);"
K5_STORE = "      xs[(wi % kDKW) * XLD + wi / kDKW] = xr[w];\n"
# the whole of the shipped branch of load(), for variants that replace it
K5R_BRANCH = """      const int rows_left = n_end - n0 - warp;  // its rows warp + 8w below n_end
      const bool col_ok = 4 * (d0 + lane) - lead_w < D;  // the word holds a byte of the row
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(xa + (size_t)(n0 + warp) * D - lead_w) + d0 + lane;
      const size_t stride = 2 * (size_t)D;  // 8 rows, in words
#pragma unroll
""" + K5R_LOADS + """      const int ext = 4 * (d0 + kDKW) - lead_t;  // aligned word 32 of the thread's row
""" + K5R_EXT
# the loads before this design: each word an address, two bounds and two
# predicated loads of the aligned words that hold it (hopper_tc.cuh
# load_words), funnel-shifted and masked in registers (shift_words)
K5R_EARLIER = """#pragma unroll
      for (int w = 0; w < XW; ++w) {
        const int wi = tid + w * kThreads, r = wi / kDKW, d = d0 + wi % kDKW;
        const bool ok = n0 + r < n_end && d < D4;
        const unsigned char* row = reinterpret_cast<const unsigned char*>(xw) + (size_t)(n0 + r) * D;
        const unsigned char* a = ok ? row + 4 * d : row;
        const int valid = ok ? min(4, D - 4 * d) : 0;
        uint32_t w2[2], v[1];
        load_words<1>(a, valid, w2);
        shift_words<1>(w2, (int)(reinterpret_cast<uintptr_t>(a) & 3), valid, v);
        xr[w] = (int)v[0];
      }
"""
# one aligned load a word at the word's address rounded down (wrong values)
K5R_ROUNDED = """#pragma unroll
      for (int w = 0; w < XW; ++w) {
        const int wi = tid + w * kThreads, r = wi / kDKW, d = d0 + wi % kDKW;
        const size_t a = xa + (size_t)(n0 + r) * D + 4 * d;
        xr[w] = n0 + r < n_end && d < D4 ? (int)__ldg(reinterpret_cast<const uint32_t*>(a & ~(size_t)3)) : 0;
      }
"""
# one row pointer, each word's two aligned words loaded and shifted into place
K5R_POINTER_TWO = K5R_LOADS.replace(
    "xr[w] = col_ok && 8 * w < rows_left ? (int)__ldg(src) : 0;",
    "const bool ok = col_ok && 8 * w < rows_left;\n"
    "        const bool ok1 = ok && 4 * (d0 + lane + 1) - lead_w < D;\n"
    "        xr[w] = (int)__funnelshift_r(ok ? __ldg(src) : 0u, ok1 ? __ldg(src + 1) : 0u, 8 * lead_w);")
# one row pointer; lane v loads aligned word 32 of row warp + 8v, and the
# stored words are realigned by __shfl_down_sync (lane 31 takes word 32 from
# lane w) and one funnel shift
K5R_SHFL_EXT = """      const bool ext_ok = lead_w != 0 && 4 * (d0 + kDKW) - lead_w < D && 8 * lane < rows_left;
      x_ext = ext_ok ? (int)__ldg(reinterpret_cast<const uint32_t*>(
                           xa + (size_t)(n0 + warp + 8 * lane) * D - lead_w) + d0 + kDKW)
                     : 0;
"""
K5R_SHFL_STORE = """      if constexpr (RAGGED) {
        const int hi = __shfl_down_sync(0xffffffffu, xr[w], 1);
        const int ext_w = __shfl_sync(0xffffffffu, x_ext, w);
        xs[(wi % kDKW) * XLD + wi / kDKW] =
            (int)__funnelshift_r((uint32_t)xr[w], (uint32_t)(lane == 31 ? ext_w : hi), 8 * lead_w);
      } else {
        xs[(wi % kDKW) * XLD + wi / kDKW] = xr[w];
      }
"""
PLAIN_READ = "xv = xs[c * XLD + tid];"
RAGGED_K5_VARIANTS = {
    "shipped": ([], {}, True),
    "the earlier loads: an address, two bounds and two loads a word": (
        [(K5R_BRANCH, K5R_EARLIER), (K5R_EXT_STORE, ""), (K5R_SHIFT, PLAIN_READ)], {}, True),
    "one row pointer, two loads a word shifted in registers": (
        [(K5R_LOADS, K5R_POINTER_TWO), (K5R_EXT, ""), (K5R_EXT_STORE, ""),
         (K5R_SHIFT, PLAIN_READ)], {}, True),
    "one row pointer, realigned by __shfl_down_sync on the store": (
        [(K5R_EXT, K5R_SHFL_EXT), (K5_STORE, K5R_SHFL_STORE), (K5R_EXT_STORE, ""),
         (K5R_SHIFT, PLAIN_READ)], {}, True),
    "no corpus loads (timing only)": (
        [(K5R_LOADS, K5R_LOADS.replace("col_ok && 8 * w < rows_left ? (int)__ldg(src) : 0", "0")),
         (K5R_EXT, "      x_ext = 0;\n")], {}, False),
    "the earlier kernel without corpus loads (timing only)": (
        [(K5R_BRANCH, "#pragma unroll\n      for (int w = 0; w < XW; ++w) xr[w] = 0;\n"),
         (K5R_EXT_STORE, ""), (K5R_SHIFT, PLAIN_READ)], {}, False),
    "one aligned load a word at its address rounded down (timing only)": (
        [(K5R_BRANCH, K5R_ROUNDED), (K5R_EXT_STORE, ""), (K5R_SHIFT, PLAIN_READ)], {}, False),
    "one row pointer, no word 32 and no shift (timing only)": (
        [(K5R_EXT, "      x_ext = 0;\n"), (K5R_SHIFT, PLAIN_READ)], {}, False),
}
RAGGED_K5_SHAPES = ((1, 100), (1, 300), (8, 100), (8, 300))


def _int8_rows(g, N, D, dev):
    """Quantized unit rows [N, D] int8 and their scales, made on the card in
    chunks, and a bias with 1% of the rows tombstoned."""
    xv = torch.empty((N, D), dtype=torch.int8, device=dev)
    xs = torch.empty(N, device=dev)
    for base in range(0, N, 131072):
        n = min(131072, N - base)
        xv[base: base + n], xs[base: base + n] = quantize.quantize_rows(
            cs._unit(torch, torch.randn(n, D, generator=g, device=dev)))
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = cs.NEG_INF
    return xv, xs, bias


def main_ragged_k5(args) -> int:
    """--ragged-k5: K5r's variants at D = 765 beside K5 at D = 764, in turns."""
    chosen = vh.chosen(RAGGED_K5_VARIANTS, args.only)
    built = vh.build_all(chosen, RAGGED_K5_VARIANTS, SOURCES,
                         ("int8_dp4a_ragged_pass1", "int8_dp4a_pass1"), "variants_ragged_k5")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2032)
    N = args.rows
    corpora = {D: _int8_rows(g, N, D, dev) for D in (765, 764)}
    qs = {D: {B: [quantize.quantize_rows(cs._unit(torch, torch.randn(B, D, generator=g,
                                                                      device=dev)))
                  for _ in range(7)] for B in {b for b, _ in RAGGED_K5_SHAPES}} for D in corpora}
    xv, xs, bias = corpora[765]
    ref = {(B, k): quantize.streaming_topk_int8(*qs[765][B][0], xv, xs, bias, k, tile_n=1 << 20)
           for B, k in RAGGED_K5_SHAPES}
    ms = {n: {} for n in built}
    bad = {n: 0 for n in built}

    def run(n):
        for D, route in ((765, "K5r"), (764, "K5")):
            counted = (quantize.streaming_topk_int8_cuda_realigned if route == "K5r"
                       else quantize.streaming_topk_int8_cuda)
            for B, k in RAGGED_K5_SHAPES:
                fn = lambda b: quantize.streaming_topk_int8_cuda(*b, *corpora[D], k)  # noqa: E731
                before = counted.launches
                ms[n].setdefault(f"{route} D={D} B={B} k={k}", []).append(
                    cs._time_ms(torch, fn, qs[D][B]))
                if counted.launches != before + len(qs[D][B]) + 1:
                    raise RuntimeError(f"{route} at D={D} did not run its own instance")
                if D == 765 and RAGGED_K5_VARIANTS[n][2]:
                    s_k, i_k = fn(qs[D][B][0])
                    s_r, i_r = ref[(B, k)]
                    bad[n] += cs.check_topk(torch, None, None, None, s_k, i_k, s_r, i_r,
                                            judge=cs.int8_judge(*qs[D][B][0], xv, xs, bias))[2]
                    bad[n] += int(((s_k != s_r) & (s_r > cs.NEG_INF / 2)).sum())

    vh.in_turns(built, "int8_topk", quantize, run, {n: RAGGED_K5_VARIANTS[n][1] for n in built})
    # the library call: torch._int_mm takes a width that is a multiple of 8
    xv_lib = torch.nn.functional.pad(xv, (0, 768 - 765))
    for B, k in RAGGED_K5_SHAPES:
        lib = cs._time_ms(torch, lambda b: cs.int8_yardstick(
            torch, torch.nn.functional.pad(b[0], (0, 3)), b[1], xv_lib, xs, bias, k),
            qs[765][B][:3])
        print(json.dumps({"library": f"D=765 (zero-padded to 768) B={B} k={k}", "ms": lib}),
              flush=True)
    return vh.report(chosen, built, ms, bad, {n: RAGGED_K5_VARIANTS[n][2] for n in built})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    ap.add_argument("--ragged", action="store_true", help="time K6r (the ragged-row producer)")
    ap.add_argument("--ragged-k5", action="store_true",
                    help="K5r, int8 rows that are not 4-byte aligned (RAGGED_K5_VARIANTS)")
    ap.add_argument("--width", type=int, default=768, help="the rows' width D")
    args = ap.parse_args()
    if not vh.start():
        return 2
    if args.ragged_k5:
        return main_ragged_k5(args)
    chosen = vh.chosen(VARIANTS, args.only)
    built = vh.build_all(chosen, VARIANTS, SOURCES, ("int8_tc_pass1", "int8_tc_ragged_pass1"),
                         "variants_int8")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2025)
    N, D = args.rows, args.width
    xv, xs, bias = _int8_rows(g, N, D, dev)
    qs = {B: [quantize.quantize_rows(cs._unit(torch, torch.randn(B, D, generator=g, device=dev)))
              for _ in range(3)] for B in {b for b, _ in SHAPES}}
    ref = {}
    for B, k in SHAPES:
        qv, qsc = (t[:4].contiguous() for t in qs[B][0])
        ref[(B, k)] = quantize.streaming_topk_int8(qv, qsc, xv, xs, bias, k, tile_n=1 << 20)
    ms = {n: {} for n in built}
    bad = {n: 0 for n in built}
    k6 = (quantize.streaming_topk_int8_cuda_ragged if args.ragged
          else quantize.streaming_topk_int8_cuda_qmajor)

    def run(n):
        for B, k in SHAPES:
            ms[n].setdefault(f"B={B} k={k}", []).append(
                cs._time_ms(torch, lambda b: k6(b[0], b[1], xv, xs, bias, k), qs[B]))
            if VARIANTS[n][2]:
                s_k, i_k = k6(*qs[B][0], xv, xs, bias, k)
                args4 = (qs[B][0][0][:4], qs[B][0][1][:4], xv, xs, bias)
                e = cs.check_topk(torch, None, None, None, s_k[:4], i_k[:4], *ref[(B, k)],
                                  judge=cs.int8_judge(*args4))
                bad[n] += e[2] + int(((s_k[:4] != ref[(B, k)][0]) & (ref[(B, k)][0] > cs.NEG_INF / 2)).sum())

    # K6's plan reads the tensor-core constants from ops/topk.py
    vh.in_turns(built, "int8_topk", quantize, run, {n: VARIANTS[n][1] for n in built}, module=topk)
    return vh.report(chosen, built, ms, bad, {n: VARIANTS[n][2] for n in built})


if __name__ == "__main__":
    sys.exit(main())

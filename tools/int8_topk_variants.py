#!/usr/bin/env python3
"""Time K6 (`streaming_topk_int8_cuda_qmajor`, csrc/int8_topk.cu
`int8_tc_pass1`) against variants of its design, on one NVIDIA GPU.

    python3 tools/int8_topk_variants.py [--rows 10000000] [--only NAME,NAME]
    python3 tools/int8_topk_variants.py --ragged [--width 760] [--only NAME,NAME]

With --ragged the timed kernel is K6r (`streaming_topk_int8_cuda_ragged`,
`int8_tc_ragged_pass1`: the ragged-row producer of csrc/hopper_tc.cuh) at
--width (default 768), and the "ragged:" variant runs its producer on one
warp instead of a warpgroup (kRaggedWarps).

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    ap.add_argument("--ragged", action="store_true", help="time K6r (the ragged-row producer)")
    ap.add_argument("--width", type=int, default=768, help="the rows' width D")
    args = ap.parse_args()
    if not vh.start():
        return 2
    chosen = vh.chosen(VARIANTS, args.only)
    built = vh.build_all(chosen, VARIANTS, SOURCES, ("int8_tc_pass1", "int8_tc_ragged_pass1"),
                         "variants_int8")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2025)
    N, D = args.rows, args.width
    xv = torch.empty((N, D), dtype=torch.int8, device=dev)
    xs = torch.empty(N, device=dev)
    for base in range(0, N, 131072):
        n = min(131072, N - base)
        xv[base: base + n], xs[base: base + n] = quantize.quantize_rows(
            cs._unit(torch, torch.randn(n, D, generator=g, device=dev)))
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = cs.NEG_INF
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

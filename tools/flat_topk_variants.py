#!/usr/bin/env python3
"""Time the row-tile kernels K2 and K4 (csrc/flat_topk.cu `rows_pass1`)
against variants of their design, on one NVIDIA GPU.

    python3 tools/flat_topk_variants.py [--rows 1000000] [--only NAME,NAME]

Each variant is the committed csrc/flat_topk.cu and csrc/topk_merge.cuh
with its text changes and ops/topk.py constants (below), built and loaded
in place of the shipped library by tools/variant_harness.py (into
codegraph_tpu_torch/_build/variants/). On a 1% tombstoned f32 corpus of
unit rows at D=768 made on the card from a seed, every variant runs K2 at
B=32 and 64 (k=30, 300), B=1024 (k=30, 300) and B=256 (k=300) and K4 at B=1024
(k=30, 300): median ms over 3 batches (CUDA events), all variants in
turns, forward then backward. Variants marked `timing only`
give wrong top-k on purpose (they skip the offer or the copies); the
others are checked against a chunked matmul + topk on one batch. Prints
the card, each variant's ptxas line for K2 and K4, and one JSON line per
variant. Exits 1 if a variant's text change no longer applies, a build
fails, or a checked variant disagrees.
"""

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from codegraph_tpu_torch.ops import topk  # noqa: E402
from tools import variant_harness as vh  # noqa: E402

OFFER = "    float sc[MI][8];\n#pragma unroll\n    for (int j = 0; j < 8; ++j) {"
ISSUE_NEXT = "      issue_next();  // into the slot computed last step, now free"
# name -> (text substitutions, ops/topk.py constants it changes, checked)
VARIANTS = {
    "shipped": ([], {}, True),
    "no offer (timing only)": ([(OFFER, "    if (acc[0][0] != 1234.5f) continue;\n" + OFFER)], {},
                               False),
    "FMAs only: no offer, no copies (timing only)": (
        [(OFFER, "    if (acc[0][0] != 1234.5f) continue;\n" + OFFER), (ISSUE_NEXT, "      cp_commit();")],
        {}, False),
    "no shared bound": ([("s >= lb && ", "")], {}, True),
    "K2 fragment of 8 columns": ([("kFragJ = TRANS ? 8 : 4;", "kFragJ = 8;")], {}, True),
    "K2 fragment of 2 columns": ([("kFragJ = TRANS ? 8 : 4;", "kFragJ = TRANS ? 8 : 2;")], {},
                                 True),
    "one block per SM (no register cap)": (
        [("__launch_bounds__(kThreads, 2)\n    rows_pass1", "__launch_bounds__(kThreads, 1)\n    rows_pass1")],
        {}, True),
    "4 ring slices": ([("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
                      {"ROW_STAGES": 4}, True),
    "24-deep slices": ([("constexpr int kRDK = 16;", "constexpr int kRDK = 24;")],
                       {"ROW_DEPTH": 24}, True),
    "48-entry buffers": ([("constexpr int kCap = 32;", "constexpr int kCap = 48;")],
                         {"ROW_CAP": 48}, True),
    "128-row query tile at every B": ([], {"ROW_SMALL_QUERY_TILES": ()}, True),
    "6 ring slices (1 block/SM at 128 rows)": (
        [("constexpr int kStages = 3;", "constexpr int kStages = 6;")], {"ROW_STAGES": 6}, True),
    "32-row tile at 4 blocks per SM, 528-block target at every B": (
        [("__launch_bounds__(kThreads, 2)\n    rows_pass1",
          "__launch_bounds__(kThreads, QT == 32 ? 4 : 2)\n    rows_pass1")],
        {"TARGET_BLOCKS": {**topk.TARGET_BLOCKS, topk.K2_LAYOUT: 4 * 132}}, True),
}
SOURCES = ("flat_topk.cu", "topk_merge.cuh")  # a variant's copies; the .cu includes its header copy
SHAPES = (("K2", 32, 30), ("K2", 32, 300), ("K2", 64, 30), ("K2", 64, 300), ("K2", 1024, 30),
          ("K2", 1024, 300), ("K2", 256, 300), ("K4", 1024, 30), ("K4", 1024, 300))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    if not vh.start():
        return 2
    chosen = vh.chosen(VARIANTS, args.only)
    built = vh.build_all(chosen, VARIANTS, SOURCES, ("rows_pass1IfLb0ELi128E", "rows_pass1IfLb1ELi128E",
                                                     "rows_pass1IfLb0ELi32E"), "variants")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2024)
    N, D = args.rows, 768
    x = cs._unit(torch, torch.randn(N, D, generator=g, device=dev))
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = cs.NEG_INF
    xt = x.T.contiguous()
    fns = {"K2": lambda qb, k: topk.streaming_topk_cuda_qmajor(qb, x, bias, k),
           "K4": lambda qb, k: topk.streaming_topk_cuda_qmajor_xt(qb, xt, bias, k)}
    qs = {B: [cs._unit(torch, torch.randn(B, D, generator=g, device=dev)) for _ in range(3)]
          for B in {b for _, b, _ in SHAPES}}
    ref = {(B, k): cs.yardstick(torch, qs[B][0], x, bias, k) for _, B, k in SHAPES}
    ms = {n: {} for n in built}
    bad = {n: 0 for n in built}

    def run(n):
        for kern, B, k in SHAPES:
            key = f"{kern} B={B} k={k}"
            ms[n].setdefault(key, []).append(cs._time_ms(torch, lambda qb: fns[kern](qb, k), qs[B]))
            if VARIANTS[n][2]:
                s_k, i_k = fns[kern](qs[B][0], k)
                bad[n] += cs.check_topk(torch, qs[B][0], x, bias, s_k, i_k, *ref[(B, k)])[2]

    vh.in_turns(built, "flat_topk", topk, run, {n: VARIANTS[n][1] for n in built})
    for _, B, k in sorted({(0, b, k) for _, b, k in SHAPES}):
        lib = cs._time_ms(torch, lambda qb: cs.yardstick(torch, qb, x, bias, k), qs[B])
        print(json.dumps({"library": f"B={B} k={k}", "ms": lib}), flush=True)
    return vh.report(chosen, built, ms, bad, {n: VARIANTS[n][2] for n in built})


if __name__ == "__main__":
    sys.exit(main())

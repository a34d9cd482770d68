#!/usr/bin/env python3
"""Time the row-tile kernels K2 and K4 (csrc/flat_topk.cu `rows_pass1`)
against variants of their design, or (--k1) K1 over bf16 rows, on one
NVIDIA GPU.

    python3 tools/flat_topk_variants.py [--rows 1000000] [--only NAME,NAME]
    python3 tools/flat_topk_variants.py --k1 [--old-csrc DIR] [--rows 1000000] [--only ...]
    python3 tools/flat_topk_variants.py --ragged [--rows 1000000] [--only NAME,NAME]
    python3 tools/flat_topk_variants.py --ragged-k1 [--rows 1000000] [--only NAME,NAME]
    python3 tools/flat_topk_variants.py --ragged-xt [--rows 1000000] [--only NAME,NAME]

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

With --k1 the variants are K1_VARIANTS of K1tc (csrc/flat_topk_k1tc.cu
`bf16_k1_pass1`, with csrc/topk_merge.cuh and csrc/hopper_tc.cuh; into
_build/variants_k1/), run through `streaming_topk_cuda_k1tc` at K1_SHAPES
(B = 1 and 8, k = 30 and 300, bf16 and f32 queries) over a 1% tombstoned
bf16 corpus of unit rows, and, given --old-csrc (a csrc/ directory that
still holds K1 over bf16 rows as the column-warp `topk_pass1<bf16>` of
flat_topk.cu, e.g. an earlier commit unpacked with `git archive`), that
kernel's OLD_K1_VARIANTS at the bf16 queries' shapes, all in turns. Its
timing-only variants skip a phase (the products, the offers, pass 2), so
the differences attribute a call's time by phase; the profile variant
adds each consumer warp's cycles by phase (products and barrier waits,
scores and vote, offers, the tile barrier, flushes) and its flush rounds.

With --ragged the variants are RAGGED_VARIANTS of K2r (`rows_pass1<float,
false, QT, 4>`: f32 rows that 16-byte pieces cannot read), each timed
through K2's wrapper at RAGGED_SHAPES (B = 64, 256, 1024; k = 30, 300) on
a 1% tombstoned f32 corpus of unit rows at D = 765 beside K2's 16-byte
instance on such rows at D = 764 (the same depth slices; its code is not
changed by these variants), so that each turn carries its own reference.
Its timing-only variants take K2r's corpus copies out (the ring's corpus
slices stay zero) or replace them by 16-byte copies of the same bytes
rounded down to 16-byte addresses (wrong values); the others are
candidate designs of the copies, checked against a chunked matmul + topk.

With --ragged-k1 the variants are RAGGED_K1_VARIANTS of K1r
(`topk_ragged_pass1`: K1 over f32 rows in 4-byte pieces), timed through
K1's wrapper at RAGGED_K1_SHAPES (B = 1, 8; k = 30, 300) over 1% tombstoned
f32 rows at D = 765 beside K1's 16-byte instance at D = 764, median ms over
7 batches: the shipped loads (one row pointer a thread, into registers),
the same under register caps of 3 and 4 blocks an SM, the earlier loads
(an address and two bounds a piece), 4-byte cp.async straight into rings
of 3 and 2 transposed slices, and timing-only variants without corpus
loads or with 16-byte loads of the same bytes, addresses rounded down.

With --ragged-xt the variants are RAGGED_XT_VARIANTS of K4r (`rows_pass1<float,
true, QT, 4>`: an f32 xt that 16-byte pieces cannot read), timed through
K4's wrapper at RAGGED_SHAPES over xt [768, N] of N = rows + 3 (odd) and
rows + 2 (N % 4 = 2) beside K4's 16-byte instance over N = rows: the
shipped asynchronous 4-byte copies, 8-byte copies where N is even and the
base 8-byte aligned, and the earlier synchronous copy an element.
"""

import argparse
import ctypes
import json
import os
import pathlib
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from codegraph_tpu_torch.ops import cuda_build, topk  # noqa: E402
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

# --- K1 over bf16 rows: K1tc (csrc/flat_topk_k1tc.cu) ------------------------
K1_PRODUCTS = ("        for (int p = PIECES - 1; p >= 0; --p) {  // the smallest piece first\n"
               "          WgmmaK1")
K1_NO_PRODUCTS = ("        for (int p = PIECES - 1; p >= (a.k > 0 ? PIECES : 0); --p) {\n"
                  "          WgmmaK1")
K1_BIAS_WAIT = "    mbar_wait(meta_full + 8 * m, (tile / kMetaSlots) & 1);\n    const float* bs_t"
# skip the tile's epilogue, freeing its bias slot (timing only)
K1_NO_EPILOGUE = ("    mbar_wait(meta_full + 8 * m, (tile / kMetaSlots) & 1);\n"
                  "    if (a.k > 0) {\n      __syncwarp();\n"
                  "      if (lane == 0) mbar_arrive(meta_empty + 8 * m);\n      continue;\n    }\n"
                  "    const float* bs_t")
K1_PASS2 = ("  if (splits == 1) return 0;\n"
            "  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);\n"
            "}\n\n}  // extern")
K1_TILE_END = ("    __syncwarp();\n    if (lane == 0) mbar_arrive(meta_empty + 8 * m);\n"
               "    if (consumer_sync_or(over)) {  // every offer of the tile is in\n"
               "      flush(kCap);\n      consumer_sync();\n    }\n")
# clock64 stamps: each consumer warp's cycles in the products (and their
# barrier waits), the scores and vote, the offers, the tile barrier and the
# flushes, and its flush rounds, summed over warps in g_prof and read by
# flat_topk_k1tc_profile
K1_PROFILE = [
    ("struct K1Args {", "__device__ unsigned long long g_prof[8];\n\nstruct K1Args {"),
    ("  float acc[QN / 2];\n", "  float acc[QN / 2];\n  long long pf[6] = {0, 0, 0, 0, 0, 0};\n"
                             "  long long pc = clock64();\n"),
    ("    // The epilogue: score + bias against the query's threshold, one vote.\n",
     "    pf[0] += clock64() - pc;\n    pc = clock64();\n"
     "    // The epilogue: score + bias against the query's threshold, one vote.\n"),
    ("    bool over = false;  // this lane pushed a query's buffer past kCap\n",
     "    pf[1] += clock64() - pc;\n    pc = clock64();\n"
     "    bool over = false;  // this lane pushed a query's buffer past kCap\n"),
    (K1_TILE_END, "    pf[2] += clock64() - pc;\n    pc = clock64();\n"
                  "    __syncwarp();\n    if (lane == 0) mbar_arrive(meta_empty + 8 * m);\n"
                  "    const bool any_over = consumer_sync_or(over);\n"
                  "    pf[3] += clock64() - pc;\n    pc = clock64();\n"
                  "    if (any_over) {\n      flush(kCap);\n      consumer_sync();\n      pf[5] += 1;\n"
                  "    }\n    pf[4] += clock64() - pc;\n    pc = clock64();\n"),
    ("  flush(0);  // what is left in the buffers goes into the lists\n",
     "  flush(0);  // what is left in the buffers goes into the lists\n"
     "  if (lane == 0) {\n    for (int i = 0; i < 6; ++i) atomicAdd(&g_prof[i], (unsigned long long)pf[i]);\n"
     "    atomicAdd(&g_prof[7], 1ull);\n  }\n"),
    ("extern \"C\" {\n", "extern \"C\" {\n\nint flat_topk_k1tc_profile(unsigned long long* out) {\n"
     "  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
     "  if (err != cudaSuccess) return (int)err;\n"
     "  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));\n}\n"),
]
K1_PHASES = ("products and waits", "scores and vote", "offers", "tile barrier", "flushes",
             "flush rounds")
_K1TC_PLAN = topk.k1tc_plan


def _k1tc_plan_two_per_sm(B, N, D, k, pieces=1, group=topk.MERGE_GROUP, sms=topk.TC_SMS):
    """k1tc_plan for one wave of two blocks on each SM."""
    return _K1TC_PLAN(B, N, D, k, pieces, group, 2 * sms)


# name -> (text substitutions, ops/topk.py names it changes, checked)
K1_VARIANTS = {
    "shipped": ([], {}, True),
    "copies only: no products, no epilogue (timing only)": (
        [(K1_PRODUCTS, K1_NO_PRODUCTS), (K1_BIAS_WAIT, K1_NO_EPILOGUE)], {}, False),
    "copies and products: no epilogue (timing only)": ([(K1_BIAS_WAIT, K1_NO_EPILOGUE)], {}, False),
    "no pass 2 (timing only)": ([(K1_PASS2, "  return 0;\n}\n\n}  // extern")], {}, False),
    "no shared bound": ([("fmaxf(fmaxf(thr_s[qi], bnd[qi]), above_neg_inf)",
                          "fmaxf(thr_s[qi], above_neg_inf)"), ("s >= lb && beats", "beats")],
                        {}, True),
    "profile: cycles by phase (timing only)": (K1_PROFILE, {}, False),
    "6 ring stages": ([], {"K1TC_STAGES": (6, 4, 3)}, True),
    "4 ring stages": ([], {"K1TC_STAGES": (4, 3)}, True),
    "2 blocks per SM of 4 ring stages": (
        [("__launch_bounds__(RAGGED ? kRaggedThreads : kTcThreads, 1)\n    bf16_k1_pass1",
          "__launch_bounds__(RAGGED ? kRaggedThreads : kTcThreads, 2)\n    bf16_k1_pass1")],
        {"K1TC_STAGES": (4, 3), "k1tc_plan": _k1tc_plan_two_per_sm}, True),
    "flush at 64 entries": ([("constexpr int kCap = 32;", "constexpr int kCap = 64;")],
                            {"ROW_CAP": 64, "TC_BUF_CAP": 64 + 128}, True),
}
K1_SOURCES = ("flat_topk_k1tc.cu", "topk_merge.cuh", "hopper_tc.cuh")
K1_SHAPES = ((1, 30), (1, 300), (8, 30), (8, 300))
# --- the column-warp K1 over bf16 rows it replaced (topk_pass1<bf16>, read
# from --old-csrc's flat_topk.cu): its time by phase
OLD_FMAS = "#pragma unroll 4\n    for (int c = 0; c < kDK; ++c) {"
OLD_OFFER = "    if (chunk != n_chunks - 1) continue;"
OLD_PASS2 = ("  if (splits == 1) return 0;\n"
             "  return (int)merge_splits(B, k, splits, group, out_s, out_i, work_s, work_i, st);\n"
             "}\n\n// K2/K3/K4")
OLD_K1_VARIANTS = {
    "column warps (topk_pass1 over bf16 rows)": ([], {}, True),
    "column warps: copies and widening only (timing only)": (
        [(OLD_FMAS, "#pragma unroll 4\n    for (int c = 0; c < (k > 0 ? 0 : kDK); ++c) {"),
         (OLD_OFFER, "    if (chunk != n_chunks - 1 || k > 0) continue;")], {}, False),
    "column warps: no offer (timing only)": (
        [(OLD_OFFER, "    if (chunk != n_chunks - 1 || k > 0) continue;")], {}, False),
    "column warps: no pass 2 (timing only)": ([(OLD_PASS2, "  return 0;\n}\n\n// K2/K3/K4")],
                                              {}, False),
}
# --- K2r: f32 rows in 4-byte pieces (rows_pass1<float, false, QT, 4>) ----------
# K2r's copy loop as shipped: one row pointer a thread, rows 16 apart
K2R_COPIES = """    } else if constexpr (!TRANS) {  // 4-byte pieces: one row pointer, rows 16 apart
      // A thread's 8 elements share its depth tid % kRDK and take rows
      // tid / kRDK + 16 v: one 64-bit pointer stepped 16 rows a copy and
      // one bound a row fit the 128-row tile's registers, where an address
      // and two bounds a copy spill (PERF.md)
      constexpr int kRowStep = kThreads / kRDK;  // rows between a thread's pieces
      const int r = tid / kRDK, c = tid % kRDK;
      const int rows_left = n_end - n0 - r;  // its rows r + kRowStep v below n_end
      const bool col_ok = d0 + c < D;
      const float* src = x + ((size_t)(n0 + r) * D + d0 + c);
      const size_t step = (size_t)kRowStep * D;
      XT* dst = xs + r * XLD + c;
#pragma unroll
      for (int v = 0; v < kTN / kRowStep; ++v) {
        const bool ok = col_ok && kRowStep * v < rows_left;
        cp_async4(dst + kRowStep * v * XLD, ok ? src : x, ok ? 4 : 0);
        src += step;
      }
"""
# K2r's earlier copy loop: a 4-byte cp.async an element, each with its own
# address and two bounds
K2R_PR18 = """    } else if constexpr (!TRANS) {  // 4-byte pieces: an element a copy
#pragma unroll
      for (int v = 0; v < kTN * kRDK / kThreads; ++v) {
        const int p = tid + v * kThreads, r = p / kRDK, c = p % kRDK;
        const bool ok = n0 + r < n_end && d0 + c < D;
        cp_async4(xs + r * XLD + c, ok ? x + (size_t)(n0 + r) * D + d0 + c : x, ok ? 4 : 0);
      }
"""
K2R_RING = "  // A slice of q (and of x [N, D]) is QT (kTN) rows x kRDK / 4 pieces of 4\n"
# the ring zeroed once, so that a variant without corpus copies multiplies zeros
K2R_ZERO_RING = ("  for (int i = tid; i < kStages * (int)L::kStageBytes / 4; i += kThreads) {\n"
                 "    reinterpret_cast<float*>(smem)[i] = 0.f;\n  }\n  __syncthreads();\n" + K2R_RING)
K2R_NO_COPIES = "    } else if constexpr (!TRANS) {  // (timing only) no corpus copies\n"
K2R_ALIGNED16 = """    } else if constexpr (!TRANS) {  // (timing only) 16-byte copies, addresses rounded down
#pragma unroll
      for (int v = 0; v < XPT; ++v) {
        const int p = tid + v * kThreads, r = p / PPR, c = (p % PPR) * 4;
        const bool ok = n0 + r < n_end && d0 + c < D;
        const float* src = reinterpret_cast<const float*>(
            reinterpret_cast<size_t>(x + (size_t)(n0 + r) * D + d0 + c) & ~(size_t)15);
        cp_async16(xs + r * XLD + c, ok ? src : x, ok ? 16 : 0);
      }
"""
# shipped, and no row bound in a tile that lies inside the split
K2R_HOISTED_WHOLE = """    } else if constexpr (!TRANS) {  // 4-byte pieces: one row pointer, rows 16 apart
      constexpr int kRowStep = kThreads / kRDK;  // rows between a thread's pieces
      const int r = tid / kRDK, c = tid % kRDK;
      const int rows_left = n_end - n0 - r;  // its rows r + kRowStep v below n_end
      const bool col_ok = d0 + c < D;
      const float* src = x + ((size_t)(n0 + r) * D + d0 + c);
      const size_t step = (size_t)kRowStep * D;
      XT* dst = xs + r * XLD + c;
      if (col_ok && rows_left > kTN - kRowStep) {  // every row of the tile is in the split
#pragma unroll
        for (int v = 0; v < kTN / kRowStep; ++v) {
          cp_async4(dst + kRowStep * v * XLD, src, 4);
          src += step;
        }
      } else {
#pragma unroll
        for (int v = 0; v < kTN / kRowStep; ++v) {
          const bool ok = col_ok && kRowStep * v < rows_left;
          cp_async4(dst + kRowStep * v * XLD, ok ? src : x, ok ? 4 : 0);
          src += step;
        }
      }
"""
# each row's 16-element slice as the 5 aligned 16-byte pieces
# that hold it (4 when it starts aligned) into its 20-float slot, then, once
# the slice has landed, a pass that shifts each row into place (two threads
# a row, one warp: read, __syncwarp, write) and zeros depths past D
K2R_REALIGNED = """    } else if constexpr (!TRANS) {  // the aligned 16-byte pieces that hold each row's slice
      const size_t xend = reinterpret_cast<size_t>(x + (size_t)N * D);
#pragma unroll
      for (int v = 0; v < (kTN * 5 + kThreads - 1) / kThreads; ++v) {
        const int p = tid + v * kThreads, r = p / 5, c = p % 5;
        if (p >= kTN * 5) break;
        const size_t a = reinterpret_cast<size_t>(x + (size_t)(n0 + r) * D + d0);
        const size_t al = (a & ~(size_t)15) + 16 * c;
        const bool ok = n0 + r < n_end && (c < 4 || (a & 15) != 0) && al < xend;
        const int bytes = ok ? (xend - al < 16 ? (int)(xend - al) : 16) : 0;
        cp_async16(xs + r * XLD + 4 * c, bytes ? reinterpret_cast<const float*>(al) : x, bytes);
      }
"""
K2R_REALIGN_PASS = ISSUE_NEXT + """
      if constexpr (!TRANS && PB == 4) {  // shift each row's slice into place
        float* xw = reinterpret_cast<float*>(smem + slot * L::kStageBytes + L::kQBytes);
        const int r = tid >> 1, h = tid & 1;
        const int sh = (int)(((reinterpret_cast<size_t>(x) >> 2) + (size_t)(n0 + r) * D) & 3);
        float w[12];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float4 v = *reinterpret_cast<const float4*>(xw + r * XLD + 8 * h + 4 * i);
          w[4 * i] = v.x;
          w[4 * i + 1] = v.y;
          w[4 * i + 2] = v.z;
          w[4 * i + 3] = v.w;
        }
        __syncwarp();
        float o[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float v = sh == 0 ? w[j] : sh == 1 ? w[j + 1] : sh == 2 ? w[j + 2] : w[j + 3];
          o[j] = d0 + 8 * h + j < D ? v : 0.f;
        }
        *reinterpret_cast<float4*>(xw + r * XLD + 8 * h) = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(xw + r * XLD + 8 * h + 4) = make_float4(o[4], o[5], o[6], o[7]);
        __syncthreads();
      }"""
# name -> (text substitutions, ops/topk.py constants it changes, checked)
RAGGED_VARIANTS = {
    "shipped": ([], {}, True),
    "an address and two bounds a copy (the earlier loop)": ([(K2R_COPIES, K2R_PR18)], {}, True),
    "no corpus copies (timing only)": ([(K2R_COPIES, K2R_NO_COPIES), (K2R_RING, K2R_ZERO_RING)],
                                       {}, False),
    "16-byte copies, addresses rounded down (timing only)": ([(K2R_COPIES, K2R_ALIGNED16)], {},
                                                             False),
    "no row bound in whole tiles": ([(K2R_COPIES, K2R_HOISTED_WHOLE)], {}, True),
    "realigned 16-byte copies and a shift pass": (
        [(K2R_COPIES, K2R_REALIGNED), (ISSUE_NEXT, K2R_REALIGN_PASS)], {}, True),
}
RAGGED_SHAPES = tuple((B, k) for B in (64, 256, 1024) for k in (30, 300))
# --- K1r: f32 rows in 4-byte pieces (topk_ragged_pass1) ------------------------
# K1r's loads as shipped: one row pointer a thread, rows 8 apart, into registers
K1R_LOADS = """    if constexpr (PB == 4) {  // one row pointer, rows kThreads / VPR apart
      // A thread's XV pieces share its depth tid % VPR and take rows tid /
      // VPR + kRowStep v (the rows store() writes them to)
      constexpr int kRowStep = kThreads / VPR;
      const int r = tid / VPR, c = tid % VPR;
      const int rows_left = n_end - n0 - r;  // its rows r + kRowStep v below n_end
      const bool col_ok = d0 + c < D;
      const XT* src = x + ((size_t)(n0 + r) * D + d0 + c);
      const size_t stride = (size_t)kRowStep * D;
#pragma unroll
      for (int v = 0; v < XV; ++v) {
        xr[v] = col_ok && kRowStep * v < rows_left ? *reinterpret_cast<const Piece*>(src) : Piece{};
        src += stride;
      }
    } else {
"""
# the 16-byte instance's loads (and K1r's earlier ones: an address and two
# bounds a piece)
K1_LOADS = """#pragma unroll
      for (int v = 0; v < XV; ++v) {
        const int vi = tid + v * kThreads, r = vi / VPR, d = d0 + (vi % VPR) * EPV;
        xr[v] = (n0 + r < n_end && d < D)
                    ? *reinterpret_cast<const Piece*>(x + (size_t)(n0 + r) * D + d)
                    : Piece{};
      }
    }
"""
K1R_BOUNDS = "__launch_bounds__(kThreads)\n    topk_ragged_pass1"
K1_DK = "constexpr int kDK = 32;  // depth staged per step"
K1R_BODY = "  topk_body<float, WR, TM, TNN, 4>(q, x, bias, B, N, D, k, rows_per_split, part_s, part_i);"
# 16-byte loads of the same bytes, each address rounded down to 16 bytes
# where the row length is not a multiple of 4 (the 16-byte instance beside
# it pays a no-op mask)
K1R_ALIGNED16 = K1_LOADS.replace(
    "*reinterpret_cast<const Piece*>(x + (size_t)(n0 + r) * D + d)",
    "*reinterpret_cast<const Piece*>(\n"
    "                          reinterpret_cast<size_t>(x + (size_t)(n0 + r) * D + d) &\n"
    "                          (D & 3 ? ~(size_t)15 : ~(size_t)0))")
# 4-byte cp.async straight into the transposed slices of a ring of
# kK1rStages (a K1r design timed and not kept): no register holds a piece
K1R_RING = [
    ("constexpr int kDK = 32;  // depth staged per step\n",
     "constexpr int kDK = 32;  // depth staged per step\nconstexpr int kK1rStages = 3;\n"),
    ("""  static size_t smem(int k) {
    return sizeof(float) * ((size_t)kDK * QLD + (size_t)kDK * XLD +
                            (size_t)BT * TN) +""",
     """  static constexpr int kSlice = kDK * QLD + kDK * XLD;
  static size_t smem(int k, int slices = 1) {
    return sizeof(float) * ((size_t)slices * kSlice + (size_t)BT * TN) +"""),
    ("  constexpr int BT = L::BT, TN = L::TN, QLD = L::QLD, XLD = L::XLD, WC = L::WC;\n",
     "  constexpr int BT = L::BT, TN = L::TN, QLD = L::QLD, XLD = L::XLD, WC = L::WC;\n"
     "  constexpr bool kRing = PB == 4;\n  constexpr int kSlices = kRing ? kK1rStages : 1;\n"),
    ("  float* ss = xs + kDK * XLD;                  // [BT][TN]\n",
     "  float* ss = qs + kSlices * L::kSlice;        // [BT][TN]\n"),
    ("  auto store = [&]() {", """  auto issue = [&](int s) {  // step s into ring slot s % kSlices
    float* qw = qs + (s % kSlices) * L::kSlice;
    float* xw = qw + kDK * QLD;
    const int n0 = n_begin + (s / n_chunks) * TN;
    const int d0 = (s % n_chunks) * kDK;
    const int rows_left = n_end - n0 - warp;
    const bool col_ok = d0 + lane < D;
    const XT* src = x + ((size_t)(n0 + warp) * D + d0 + lane);
    const size_t stride = (size_t)kWarps * D;
    auto copy4 = [](void* dst, const void* from, int bytes) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n" ::"r"(
                       static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                   "l"(from), "r"(bytes)
                   : "memory");
    };
#pragma unroll
    for (int v = 0; v < TN / kWarps; ++v) {
      const bool ok = col_ok && kWarps * v < rows_left;
      copy4(xw + lane * XLD + warp + kWarps * v, ok ? src : x, ok ? 4 : 0);
      src += stride;
    }
    if (warp < BT) {  // query row b0 + warp at the same depth
      const bool ok = col_ok && b0 + warp < B;
      copy4(qw + lane * QLD + warp, ok ? q + (size_t)(b0 + warp) * D + d0 + lane : q, ok ? 4 : 0);
    }
  };
  auto store = [&]() {"""),
    ("""  if (steps > 0) load(0);
  for (int step = 0; step < steps; ++step) {""", """  if constexpr (kRing) {
#pragma unroll 1
    for (int s = 0; s < kSlices - 1; ++s) {
      if (s < steps) issue(s);
      asm volatile("cp.async.commit_group;\\n" ::: "memory");
    }
  } else {
    if (steps > 0) load(0);
  }
  for (int step = 0; step < steps; ++step) {"""),
    ("""    store();
    __syncthreads();
    if (step + 1 < steps) load(step + 1);  // in flight during the FMAs below
    const float* qstep = qs;
""", """    if constexpr (kRing) {
      asm volatile("cp.async.wait_group %0;\\n" ::"n"(kSlices - 2) : "memory");
      __syncthreads();
      if (step + kSlices - 1 < steps) issue(step + kSlices - 1);
      asm volatile("cp.async.commit_group;\\n" ::: "memory");
    } else {
      store();
      __syncthreads();
      if (step + 1 < steps) load(step + 1);
    }
    const float* qstep = qs + (step % kSlices) * L::kSlice;
    const float* xstep = qstep + kDK * QLD;
"""),
    ("xv[j] = xs[c * XLD + wc * 32 * TNN + lane + 32 * j];",
     "xv[j] = xstep[c * XLD + wc * 32 * TNN + lane + 32 * j];"),
    ("""    }
    __syncthreads();
    if (chunk != n_chunks - 1) continue;""", """    }
    if constexpr (!kRing) __syncthreads();
    if (chunk != n_chunks - 1) continue;"""),
    ("  const size_t smem = L::smem(k);\n  auto kern = ragged",
     "  const size_t smem = L::smem(k, ragged ? kK1rStages : 1);\n  auto kern = ragged"),
]
RAGGED_K1_VARIANTS = {
    "shipped": ([], {}, True),
    "at most 80 registers (3 blocks an SM)": (
        [(K1R_BOUNDS, K1R_BOUNDS.replace("kThreads)", "kThreads, 3)"))], {}, True),
    "at most 64 registers (4 blocks an SM)": (
        [(K1R_BOUNDS, K1R_BOUNDS.replace("kThreads)", "kThreads, 4)"))], {}, True),
    "an address and two bounds a piece (the earlier loads)": ([(K1R_LOADS, "    {\n")], {}, True),
    "16-deep steps (K1 too)": ([(K1_DK, K1_DK.replace("32", "16"))], {}, True),
    "16-deep steps (K1 too) capped at 80 registers": (
        [(K1_DK, K1_DK.replace("32", "16")),
         (K1R_BOUNDS, K1R_BOUNDS.replace("kThreads)", "kThreads, 3)"))], {}, True),
    "16-deep steps (K1 too) capped at 64 registers": (
        [(K1_DK, K1_DK.replace("32", "16")),
         (K1R_BOUNDS, K1R_BOUNDS.replace("kThreads)", "kThreads, 4)"))], {}, True),
    "4-byte cp.async into a ring of 3 slices": (K1R_RING, {}, True),
    "4-byte cp.async into a ring of 2 slices": (
        [(K1R_RING[0][0], K1R_RING[0][1].replace("= 3;", "= 2;"))] + K1R_RING[1:], {}, True),
    "no corpus loads (timing only)": (
        [(K1R_LOADS, K1R_LOADS.replace(
            "col_ok && kRowStep * v < rows_left ? *reinterpret_cast<const Piece*>(src) : Piece{}",
            "Piece{}"))], {}, False),
    "16-byte loads of the same bytes at addresses rounded down (timing only)": (
        [(K1R_BODY, K1R_BODY.replace(", 4>", ", 16>")), (K1_LOADS, K1R_ALIGNED16)], {}, False),
}
RAGGED_K1_SHAPES = ((1, 30), (1, 300), (8, 30), (8, 300))
# --- K4r: an f32 xt in 4-byte pieces (rows_pass1<float, true, QT, 4>) -----------
K4R_COPIES = """      constexpr int kDepthStep = kThreads / kTN;  // depths between a thread's pieces
      const int dr = tid / kTN, c = tid % kTN;
      const int depths_left = D - d0 - dr;  // its depths dr + kDepthStep v below D
      const bool col_ok = n0 + c < n_end;
      const XT* src = x + ((size_t)(d0 + dr) * N + n0 + c);
      const size_t step = (size_t)kDepthStep * N;
      XT* dst = xs + dr * XLD + c;
#pragma unroll
      for (int v = 0; v < kRDK / kDepthStep; ++v) {
        const bool ok = col_ok && kDepthStep * v < depths_left;
        cp_async4(dst + kDepthStep * v * XLD, ok ? src : x, ok ? 4 : 0);
        src += step;
      }
"""
# 8-byte copies (two columns) where N is even and the base 8-byte aligned:
# a split ends at an even column, so a pair is wholly in or out
K4R_EIGHT = """      if ((N & 1) == 0 && (reinterpret_cast<size_t>(x) & 7) == 0) {
        constexpr int kDepthStep = kThreads / (kTN / 2);
        const int dr = tid / (kTN / 2), c = (tid % (kTN / 2)) * 2;
        const int depths_left = D - d0 - dr;
        const bool col_ok = n0 + c < n_end;
        const XT* src = x + ((size_t)(d0 + dr) * N + n0 + c);
        const size_t step = (size_t)kDepthStep * N;
        XT* dst = xs + dr * XLD + c;
#pragma unroll
        for (int v = 0; v < kRDK / kDepthStep; ++v) {
          const bool ok = col_ok && kDepthStep * v < depths_left;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\\n" ::"r"(
                           smem_u32(dst + kDepthStep * v * XLD)),
                       "l"(ok ? src : x), "r"(ok ? 8 : 0)
                       : "memory");
          src += step;
        }
      } else {
""" + K4R_COPIES + "      }\n"
# the copy before K4r's: an element a thread, loaded and stored by the thread
K4R_SYNC = """      const unsigned* xr = reinterpret_cast<const unsigned*>(x);
      unsigned* xw = reinterpret_cast<unsigned*>(xs);
#pragma unroll
      for (int v = 0; v < kRDK * kTN / kThreads; ++v) {
        const int p = tid + v * kThreads, dr = p / kTN, c = p % kTN;
        xw[dr * XLD + c] = (d0 + dr < D && n0 + c < n_end) ? xr[(size_t)(d0 + dr) * N + n0 + c] : 0u;
      }
"""
RAGGED_XT_VARIANTS = {
    "shipped": ([], {}, True),
    "8-byte pieces where N is even and the base 8-byte aligned": ([(K4R_COPIES, K4R_EIGHT)], {},
                                                                   True),
    "a synchronous copy an element (the earlier copies)": ([(K4R_COPIES, K4R_SYNC)], {}, True),
}

SHAPES = (("K2", 32, 30), ("K2", 32, 300), ("K2", 64, 30), ("K2", 64, 300), ("K2", 1024, 30),
          ("K2", 1024, 300), ("K2", 256, 300), ("K4", 1024, 30), ("K4", 1024, 300))


def _old_k1(lib, q, x, bias, k):
    """The column-warp K1 of an earlier flat_topk.cu over bf16 rows, through
    its C entry (q widened to f32, x_bf16 = 1), as its wrapper launched it."""
    B, D = q.shape
    N = x.shape[0]
    tm = topk.k1_tm(B)
    splits, rows = topk._plan(B, N, topk.K1_LAYOUT, tm)
    out_s, out_i, work_s, work_i = topk._outputs(B, k, topk.work_entries(B, k, splits), q.device)
    qf = q.float().contiguous()
    err = lib.flat_topk(qf.data_ptr(), x.data_ptr(), 1, bias.data_ptr(), B, N, D, k, tm, splits,
                        rows, topk.MERGE_GROUP, out_s.data_ptr(), out_i.data_ptr(),
                        work_s.data_ptr(), work_i.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the column-warp K1 failed: CUDA error {err}")
    return out_s, out_i


def main_k1(args) -> int:
    """--k1: K1tc's variants and, given --old-csrc, the column-warp K1's."""
    old_dir = pathlib.Path(args.old_csrc) if args.old_csrc else None
    variants = dict(K1_VARIANTS)
    if old_dir is not None:
        variants.update(OLD_K1_VARIANTS)
    chosen = vh.chosen(variants, args.only)
    new = [n for n in chosen if n in K1_VARIANTS]
    old = [n for n in chosen if n in OLD_K1_VARIANTS]
    built = vh.build_all(new, K1_VARIANTS, K1_SOURCES, ("bf16_k1_pass1",), "variants_k1")
    built.update(vh.build_all(old, OLD_K1_VARIANTS, SOURCES, ("topk_pass1I13__nv_bfloat16",),
                              "variants_k1_old", csrc=old_dir))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2026)
    N, D = args.rows, 768
    x = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
    for base in range(0, N, 131072):
        n = min(131072, N - base)
        x[base: base + n] = cs._unit(torch, torch.randn(n, D, generator=g, device=dev))
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = cs.NEG_INF
    qs = {B: [cs._unit(torch, torch.randn(B, D, generator=g, device=dev)) for _ in range(3)]
          for B in {b for b, _ in K1_SHAPES}}
    ref = {(B, k, qd): cs.yardstick(torch, qs[B][0].to(qd), x, bias, k) for B, k in K1_SHAPES
           for qd in (torch.bfloat16, torch.float32)}
    ms = {n: {} for n in built}
    prof = {n: {} for n in built}
    bad = {n: 0 for n in built}
    saved = {a: getattr(topk, a) for v in K1_VARIANTS.values() for a in v[1]}

    def run(n, lib):
        if n in OLD_K1_VARIANTS:
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.flat_topk.argtypes = [p, p, i, p, i, i, i, i, i, i, i, i, p, p, p, p, p]
            fn, dtypes = (lambda qb, k: _old_k1(lib, qb, x, bias, k)), (torch.bfloat16,)
        else:
            cuda_build._loaded["flat_topk_k1tc"] = lib
            topk._k1tc_lib_handle = None
            for a, v in {**saved, **K1_VARIANTS[n][1]}.items():
                setattr(topk, a, v)
            fn = lambda qb, k: topk.streaming_topk_cuda_k1tc(qb, x, bias, k)  # noqa: E731
            dtypes = (torch.bfloat16, torch.float32)
        profiled = n.startswith("profile")
        if profiled:
            lib.flat_topk_k1tc_profile.argtypes = [ctypes.c_void_p]
            counts = (ctypes.c_ulonglong * 8)()
            lib.flat_topk_k1tc_profile(counts)  # zero
        for qd in dtypes:
            for B, k in K1_SHAPES:
                key = f"B={B} k={k} q {str(qd)[6:]}"
                batches = [qb.to(qd) for qb in qs[B]]
                ms[n].setdefault(key, []).append(cs._time_ms(torch, lambda qb: fn(qb, k), batches))
                if profiled:  # cycles per consumer warp and launch, by phase
                    torch.cuda.synchronize()
                    if lib.flat_topk_k1tc_profile(counts):
                        raise RuntimeError("flat_topk_k1tc_profile failed")
                    per = {ph: counts[i] / max(1, counts[7]) for i, ph in enumerate(K1_PHASES)}
                    prof[n].setdefault(key, []).append(per)
                if variants[n][2]:
                    s_k, i_k = fn(batches[0], k)
                    bad[n] += cs.check_topk(torch, batches[0], x, bias, s_k, i_k,
                                            *ref[(B, k, qd)])[2]

    names = list(built)
    try:
        for n in names + names[::-1]:
            run(n, ctypes.CDLL(built[n]))
    finally:
        cuda_build._loaded.pop("flat_topk_k1tc", None)
        topk._k1tc_lib_handle = None
        for a, v in saved.items():
            setattr(topk, a, v)
    for B, k in K1_SHAPES:
        for name, lib_fn in (("yardstick_tc", cs.yardstick_tc), ("yardstick", cs.yardstick)):
            lib_ms = cs._time_ms(torch, lambda qb: lib_fn(torch, qb.to(torch.bfloat16), x, bias, k),
                                 qs[B])
            print(json.dumps({"library": name, "shape": f"B={B} k={k}", "ms": lib_ms}), flush=True)
    return vh.report(chosen, built, ms, bad, {n: variants[n][2] for n in built},
                     {n: {"cycles_per_warp": prof[n]} for n in built if prof[n]})


def main_ragged(args) -> int:
    """--ragged: K2r's variants at D = 765 beside K2 at D = 764, in turns."""
    chosen = vh.chosen(RAGGED_VARIANTS, args.only)
    built = vh.build_all(chosen, RAGGED_VARIANTS, SOURCES,
                         ("rows_pass1IfLb0ELi128ELi4E", "rows_pass1IfLb0ELi64ELi4E",
                          "rows_pass1IfLb0ELi128ELi16E"), "variants_ragged")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2027)
    N = args.rows
    xs, qs, ref = {}, {}, {}
    for D in (765, 764):
        x = torch.empty((N, D), device=dev)
        for base in range(0, N, 131072):
            n = min(131072, N - base)
            x[base: base + n] = cs._unit(torch, torch.randn(n, D, generator=g, device=dev))
        xs[D] = x
        qs[D] = {B: [cs._unit(torch, torch.randn(B, D, generator=g, device=dev)) for _ in range(3)]
                 for B in {b for b, _ in RAGGED_SHAPES}}
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = cs.NEG_INF
    for B, k in RAGGED_SHAPES:
        q16 = qs[765][B][0][:16].contiguous()
        ref[(B, k)] = (q16, cs.yardstick(torch, q16, xs[765], bias, k))
    ms = {n: {} for n in built}
    bad = {n: 0 for n in built}

    def run(n):
        for D, route in ((765, "K2r"), (764, "K2")):
            for B, k in RAGGED_SHAPES:
                fn = lambda qb: topk.streaming_topk_cuda_qmajor(qb, xs[D], bias, k)  # noqa: E731
                ms[n].setdefault(f"{route} D={D} B={B} k={k}", []).append(
                    cs._time_ms(torch, fn, qs[D][B]))
                if D == 765 and RAGGED_VARIANTS[n][2]:
                    q16, (s_y, i_y) = ref[(B, k)]
                    s_k, i_k = topk.streaming_topk_cuda_qmajor(qs[D][B][0], xs[D], bias, k)
                    bad[n] += cs.check_topk(torch, q16, xs[D], bias, s_k[:16], i_k[:16], s_y,
                                            i_y)[2]

    vh.in_turns(built, "flat_topk", topk, run, {n: RAGGED_VARIANTS[n][1] for n in built})
    for B, k in RAGGED_SHAPES:
        lib = cs._time_ms(torch, lambda qb: cs.yardstick(torch, qb, xs[765], bias, k),
                          qs[765][B])
        print(json.dumps({"library": f"D=765 B={B} k={k}", "ms": lib}), flush=True)
    return vh.report(chosen, built, ms, bad, {n: RAGGED_VARIANTS[n][2] for n in built})


def _f32_rows(torch, g, N, D, dev):
    """Unit f32 rows [N, D] made on the card in chunks."""
    x = torch.empty((N, D), device=dev)
    for base in range(0, N, 131072):
        n = min(131072, N - base)
        x[base: base + n] = cs._unit(torch, torch.randn(n, D, generator=g, device=dev))
    return x


def main_ragged_k1(args) -> int:
    """--ragged-k1: K1r's variants at D = 765 beside K1 at D = 764, in turns."""
    chosen = vh.chosen(RAGGED_K1_VARIANTS, args.only)
    built = vh.build_all(chosen, RAGGED_K1_VARIANTS, SOURCES,
                         ("topk_ragged_pass1", "topk_pass1"), "variants_ragged_k1")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2030)
    N = args.rows
    xs = {D: _f32_rows(torch, g, N, D, dev) for D in (765, 764)}
    qs = {D: {B: [cs._unit(torch, torch.randn(B, D, generator=g, device=dev)) for _ in range(7)]
              for B in {b for b, _ in RAGGED_K1_SHAPES}} for D in xs}
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = cs.NEG_INF
    ref = {(B, k): cs.yardstick(torch, qs[765][B][0], xs[765], bias, k)
           for B, k in RAGGED_K1_SHAPES}
    ms = {n: {} for n in built}
    bad = {n: 0 for n in built}

    def run(n):
        for D, route in ((765, "K1r"), (764, "K1")):
            for B, k in RAGGED_K1_SHAPES:
                fn = lambda qb: topk.streaming_topk_cuda(qb, xs[D], bias, k)  # noqa: E731
                ms[n].setdefault(f"{route} D={D} B={B} k={k}", []).append(
                    cs._time_ms(torch, fn, qs[D][B]))
                if D == 765 and RAGGED_K1_VARIANTS[n][2]:
                    s_k, i_k = fn(qs[D][B][0])
                    bad[n] += cs.check_topk(torch, qs[D][B][0], xs[D], bias, s_k, i_k,
                                            *ref[(B, k)])[2]

    vh.in_turns(built, "flat_topk", topk, run, {n: RAGGED_K1_VARIANTS[n][1] for n in built})
    for B, k in RAGGED_K1_SHAPES:
        lib = cs._time_ms(torch, lambda qb: cs.yardstick(torch, qb, xs[765], bias, k),
                          qs[765][B])
        print(json.dumps({"library": f"D=765 B={B} k={k}", "ms": lib}), flush=True)
    return vh.report(chosen, built, ms, bad, {n: RAGGED_K1_VARIANTS[n][2] for n in built})


def main_ragged_xt(args) -> int:
    """--ragged-xt: K4r's variants over xt of N = rows + 3 and rows + 2
    beside K4 over N = rows, in turns."""
    chosen = vh.chosen(RAGGED_XT_VARIANTS, args.only)
    built = vh.build_all(chosen, RAGGED_XT_VARIANTS, SOURCES,
                         ("rows_pass1IfLb1ELi128ELi4E", "rows_pass1IfLb1ELi64ELi4E",
                          "rows_pass1IfLb1ELi128ELi16E"), "variants_ragged_xt")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2031)
    D = 768
    xts, bias, ref = {}, {}, {}
    for N in (args.rows + 3, args.rows + 2, args.rows):
        xts[N] = _f32_rows(torch, g, N, D, dev).T.contiguous()
        torch.cuda.empty_cache()
        bias[N] = torch.zeros(N, device=dev)
        bias[N][torch.randperm(N, generator=g, device=dev)[: N // 100]] = cs.NEG_INF
    qs = {B: [cs._unit(torch, torch.randn(B, D, generator=g, device=dev)) for _ in range(3)]
          for B in {b for b, _ in RAGGED_SHAPES}}
    for N in xts:
        for B, k in RAGGED_SHAPES:
            q16 = qs[B][0][:16].contiguous()
            ref[(N, B, k)] = (q16, cs.yardstick(torch, q16, xts[N], bias[N], k, xt=True))
    ms = {n: {} for n in built}
    bad = {n: 0 for n in built}

    def run(n):
        for N, xt in xts.items():
            route = "K4" if N == args.rows else "K4r"
            for B, k in RAGGED_SHAPES:
                fn = lambda qb: topk.streaming_topk_cuda_qmajor_xt(qb, xt, bias[N], k)  # noqa: E731
                ms[n].setdefault(f"{route} N={N} B={B} k={k}", []).append(
                    cs._time_ms(torch, fn, qs[B]))
                if route == "K4r" and RAGGED_XT_VARIANTS[n][2]:
                    q16, (s_y, i_y) = ref[(N, B, k)]
                    s_k, i_k = fn(qs[B][0])
                    bad[n] += cs.check_topk(torch, q16, xt.T, bias[N], s_k[:16], i_k[:16], s_y,
                                            i_y)[2]

    vh.in_turns(built, "flat_topk", topk, run, {n: RAGGED_XT_VARIANTS[n][1] for n in built})
    for N, xt in xts.items():
        for B, k in RAGGED_SHAPES:
            lib = cs._time_ms(torch, lambda qb: cs.yardstick(torch, qb, xt, bias[N], k, xt=True),
                              qs[B])
            print(json.dumps({"library": f"xt N={N} B={B} k={k}", "ms": lib}), flush=True)
    return vh.report(chosen, built, ms, bad, {n: RAGGED_XT_VARIANTS[n][2] for n in built})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    ap.add_argument("--k1", action="store_true", help="K1 over bf16 rows (K1_VARIANTS)")
    ap.add_argument("--ragged", action="store_true",
                    help="K2r, f32 rows in 4-byte pieces (RAGGED_VARIANTS)")
    ap.add_argument("--ragged-k1", action="store_true",
                    help="K1r, f32 rows in 4-byte pieces (RAGGED_K1_VARIANTS)")
    ap.add_argument("--ragged-xt", action="store_true",
                    help="K4r, an f32 xt in 4-byte pieces (RAGGED_XT_VARIANTS)")
    ap.add_argument("--old-csrc", default="", help="with --k1: a csrc/ directory holding the "
                    "column-warp K1 over bf16 rows, to time it too")
    args = ap.parse_args()
    if not vh.start():
        return 2
    if args.k1:
        return main_k1(args)
    if args.ragged:
        return main_ragged(args)
    if args.ragged_k1:
        return main_ragged_k1(args)
    if args.ragged_xt:
        return main_ragged_xt(args)
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

#!/usr/bin/env python3
"""Time the row-tile kernels K2 and K4 (csrc/flat_topk.cu `rows_pass1`)
against variants of their design, or (--k1) K1 over bf16 rows, on one
NVIDIA GPU.

    python3 tools/flat_topk_variants.py [--rows 1000000] [--only NAME,NAME]
    python3 tools/flat_topk_variants.py --k1 [--old-csrc DIR] [--rows 1000000] [--only ...]

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
        [("__launch_bounds__(kTcThreads, 1)\n    bf16_k1_pass1",
          "__launch_bounds__(kTcThreads, 2)\n    bf16_k1_pass1")],
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    ap.add_argument("--k1", action="store_true", help="K1 over bf16 rows (K1_VARIANTS)")
    ap.add_argument("--old-csrc", default="", help="with --k1: a csrc/ directory holding the "
                    "column-warp K1 over bf16 rows, to time it too")
    args = ap.parse_args()
    if not vh.start():
        return 2
    if args.k1:
        return main_k1(args)
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

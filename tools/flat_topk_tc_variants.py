#!/usr/bin/env python3
"""Time K2tc (K2 over bf16 queries and bf16 rows, `streaming_topk_cuda_tc`,
csrc/flat_topk_tc.cu `bf16_tc_pass1`) against variants of its design, on
one NVIDIA GPU.

    python3 tools/flat_topk_tc_variants.py [--rows 1000000] [--only NAME,NAME]

Each variant is the committed csrc/flat_topk_tc.cu and csrc/topk_merge.cuh
with its text changes and ops/topk.py constants (below), built and loaded
in place of the shipped library by tools/variant_harness.py (into
codegraph_tpu_torch/_build/variants_tc/). On a 1% tombstoned
bf16 corpus of unit rows at D=768 made on the card from a seed, every
variant runs K2tc at B=64, 256 and 1024, k=30 and 300: median ms over 3
batches (CUDA events), all variants in turns, forward then backward.
Variants marked `timing only` give wrong top-k on purpose (they skip the
epilogue, the offer or the merge into the lists); the others are checked
against the plain version on four rows of one batch. Prints the card, each
variant's ptxas line for bf16_tc_pass1, and one JSON line per variant; the
profile variant adds, for each consumer warp and launch (a launch's sum over
its warps over their count), its cycles by phase (products and barrier
waits, scores and vote, offer rounds, flushes), the offer rounds it visited,
the candidates it buffered and the row flushes it ran in the tile loop.
Exits 1 if a variant's text change no longer applies, a build fails, or a
checked variant disagrees.
"""

import argparse
import ctypes
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from codegraph_tpu_torch.ops import topk  # noqa: E402
from tools import variant_harness as vh  # noqa: E402

EPILOGUE = "      // The epilogue. acc[4j + 2h + e]"
OFFER = "      if (rounds) {"
BOUND_TEST = "s >= lb[h] && beats"
BOUND_THR = "fmaxf(fmaxf(st.thr_s()[sr], st.bnd()[sr]), above_neg_inf)"
FLUSH = "merge_sorted(stage_s"
SORT = "        sort_buffer(stage_s, stage_i, n, hmask, l16);\n"
ROUNDS = """        unsigned rm = rounds;
#pragma unroll 1
        while (rm) {  // warp-uniform
          const int r = __ffs(rm) - 1;
          rm &= rm - 1;
          const int n = n0 + 8 * (r >> 1) + 2 * t + (r & 1);
          const bool mine = (hit >> r) & 1u;
          float s0 = 0.f, s1 = 0.f;
          round_sums(acc, r, s0, s1);
"""
# every round's code unrolled, its sums at compile-time indices (no switch)
ROUNDS_UNROLLED = """#pragma unroll
        for (int r = 0; r < 32; ++r) {
          if (!((rounds >> r) & 1u)) continue;  // warp-uniform
          const int n = n0 + 8 * (r >> 1) + 2 * t + (r & 1);
          const bool mine = (hit >> r) & 1u;
          const float s0 = acc[4 * (r >> 1) + (r & 1)];
          const float s1 = acc[4 * (r >> 1) + 2 + (r & 1)];
"""
CAP = "constexpr int kCap = 32;"
STAGING = """        for (int p = l16; p < n; p += 16) {
          stage_s[p] = __ldcg(cand_s + (size_t)fr * kBufCap + p);
          stage_i[p] = __ldcg(cand_i + (size_t)fr * kBufCap + p);
        }
"""
# the staging copy of a flush with its loads issued together, then its stores
STAGING_BATCHED = """        float vs[kBufCap / 16];
        int vi[kBufCap / 16];
#pragma unroll
        for (int e = 0; e < kBufCap / 16; ++e) {
          const int p = l16 + 16 * e;
          if (p < n) {
            vs[e] = __ldcg(cand_s + (size_t)fr * kBufCap + p);
            vi[e] = __ldcg(cand_i + (size_t)fr * kBufCap + p);
          }
        }
#pragma unroll
        for (int e = 0; e < kBufCap / 16; ++e) {
          const int p = l16 + 16 * e;
          if (p < n) {
            stage_s[p] = vs[e];
            stage_i[p] = vi[e];
          }
        }
"""
IN_LOOP_FLUSH = """        if (full0 | full1) {
          tc_flush_rows(full0, full1, st, cand_s, cand_i, stage, wrow, wb, a.part_s,
                        a.part_i, a.bound, k, S, lslot);
        }
"""
# clock64 stamps: each consumer warp's cycles in the products (and their
# barrier waits), the scores and vote, the offer rounds and the flushes,
# summed over warps in g_prof and read by flat_topk_tc_profile
PROFILE = [
    ("struct TcArgs {", "__device__ unsigned long long g_prof[8];\n\nstruct TcArgs {"),
    ("    float acc[64];\n", "    float acc[64];\n    long long pf[7] = {0, 0, 0, 0, 0, 0, 0};\n"
                          "    long long pc = clock64();\n"),
    ("          rm &= rm - 1;\n", "          rm &= rm - 1;\n          pf[4] += 1;\n"),
    ("            const unsigned qb = (__ballot_sync(kFull, v) >> (4 * g)) & 0xFu;\n",
     "            const unsigned qb = (__ballot_sync(kFull, v) >> (4 * g)) & 0xFu;\n"
     "            pf[5] += __popc(__ballot_sync(kFull, v));\n"),
    ("      const float* bs_t = ", "      pf[0] += clock64() - pc;\n      pc = clock64();\n"
                                 "      const float* bs_t = "),
    ("      const unsigned rounds = __reduce_or_sync(kFull, hit);\n",
     "      const unsigned rounds = __reduce_or_sync(kFull, hit);\n"
     "      pf[1] += clock64() - pc;\n      pc = clock64();\n"),
    (IN_LOOP_FLUSH, "        pf[2] += clock64() - pc;\n        pc = clock64();\n"
     "        pf[6] += __popc(full0) + __popc(full1);\n" + IN_LOOP_FLUSH +
     "        pf[3] += clock64() - pc;\n        pc = clock64();\n"),
    ("    // what is left in the buffers goes into the lists\n",
     "    if (lane == 0) {\n      for (int i = 0; i < 7; ++i) atomicAdd(&g_prof[i], (unsigned long long)pf[i]);\n"
     "      atomicAdd(&g_prof[7], 1ull);\n    }\n"
     "    // what is left in the buffers goes into the lists\n"),
    ("extern \"C\" {\n", "extern \"C\" {\n\nint flat_topk_tc_profile(unsigned long long* out) {\n"
     "  cudaError_t err = cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
     "  if (err != cudaSuccess) return (int)err;\n"
     "  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  return (int)cudaMemcpyToSymbol(g_prof, zero, sizeof(g_prof));\n}\n"),
]
PHASES = ("products and waits", "scores and vote", "offer rounds", "flushes",
          "rounds visited", "candidates", "row flushes in the loop")
# A warpgroup's full rows flushed by its 8 half-warps together (the i-th
# full row by half-warp i mod 8) between two named barriers, instead of each
# warp flushing its own 16 rows while its warpgroup waits at the next wgmma.
GROUP_FN = """__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\\n" ::"r"(id) : "memory");
}

__device__ __noinline__ void tc_flush_group(unsigned long long full, TcState st,
                                            const float* cand_s, const int* cand_i,
                                            unsigned char* stage, int grow, int gb, float* part_s,
                                            int* part_i, float* bound, int k, int S, int lslot) {
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4, l16 = lane & 15;
  const unsigned hmask = 0xFFFFu << (16 * half);
  const int hw = ((threadIdx.x >> 5) & 3) * 2 + half;
  const int area = (threadIdx.x >> 5) * 2 + half;
  float* const stage_s = reinterpret_cast<float*>(stage) + area * kBufCap;
  int* const stage_i = reinterpret_cast<int*>(stage) + kHalfWarps * kBufCap + area * kBufCap;
  int idx = 0;
#pragma unroll 1
  for (unsigned long long f = full; f; f &= f - 1, ++idx) {
    if ((idx & 7) != hw) continue;
    const int r = __ffsll((long long)f) - 1;
    const int fr = grow + r, fb = gb + r;
    const int n = st.cnt()[fr];
    for (int p = l16; p < n; p += 16) {
      stage_s[p] = __ldcg(cand_s + (size_t)fr * kBufCap + p);
      stage_i[p] = __ldcg(cand_i + (size_t)fr * kBufCap + p);
    }
    sort_buffer(stage_s, stage_i, n, hmask, l16);
    const size_t base = ((size_t)fb * S + lslot) * k;
    merge_sorted(stage_s, stage_i, n, part_s + base, part_i + base, k, st.len() + fr,
                 st.thr_s() + fr, st.thr_i() + fr, hmask, l16);
    share_bound_inline(part_s + base, k, bound + (size_t)fb * S, lslot, S, st.bnd() + fr, hmask,
                       l16);
  }
  __syncwarp();
}

// Pass 1 of K2/K3 over bf16 rows:"""
GROUP_LAMBDA = """    const int grow = wg * kWgM;
    auto flush_full = [&](int cap) {
      wg_barrier(1 + wg);
      const unsigned lo32 = __ballot_sync(kFull, st.cnt()[grow + lane] > cap);
      const unsigned hi32 = __ballot_sync(kFull, st.cnt()[grow + 32 + lane] > cap);
      const unsigned long long full = lo32 | (unsigned long long)hi32 << 32;
      if (full) {
        tc_flush_group(full, st, cand_s, cand_i, stage, grow, b0 + grow, a.part_s, a.part_i,
                       a.bound, k, S, lslot);
        wg_barrier(1 + wg);
        if (lane < 16 && ((full >> (16 * warp + lane)) & 1ull)) st.cnt()[wrow + lane] = 0;
        __syncwarp();
      }
    };
    if (a.resident) mbar_wait(q_bar, 0);
"""
WARP_FLUSH = """        const unsigned full0 = __ballot_sync(kFull, t == 0 && cnt[0] > kCap);
        const unsigned full1 = __ballot_sync(kFull, t == 0 && cnt[1] > kCap);
        __syncwarp();
        if (full0 | full1) {
          tc_flush_rows(full0, full1, st, cand_s, cand_i, stage, wrow, wb, a.part_s,
                        a.part_i, a.bound, k, S, lslot);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(meta_empty + 8 * m);
"""
WARP_LEFT = """    __syncwarp();
    const unsigned left0 = __ballot_sync(kFull, (lane & 3) == 0 && st.cnt()[wrow + g] > 0);
    const unsigned left1 = __ballot_sync(kFull, (lane & 3) == 0 && st.cnt()[wrow + g + 8] > 0);
    if (left0 | left1) {
      tc_flush_rows(left0, left1, st, cand_s, cand_i, stage, wrow, wb, a.part_s,
                    a.part_i, a.bound, k, S, lslot);
    }
"""
GROUP_FLUSH = [
    ("// Pass 1 of K2/K3 over bf16 rows:", GROUP_FN),
    ("    if (a.resident) mbar_wait(q_bar, 0);\n", GROUP_LAMBDA),
    (WARP_FLUSH, "      }\n      __syncwarp();\n      if (lane == 0) mbar_arrive(meta_empty + 8 * m);\n"
                 "      flush_full(kCap);\n"),
    (WARP_LEFT, "    flush_full(0);\n"),
]
# name -> (text substitutions, ops/topk.py constants it changes, checked)
VARIANTS = {
    "shipped": ([], {}, True),
    "products only: no epilogue (timing only)": (
        [(EPILOGUE, "      if (a.k > 0) {  // free the tile's bias slot\n"
                    "        if (lane == 0) mbar_arrive(meta_empty + 8 * m);\n"
                    "        continue;\n      }\n" + EPILOGUE)], {}, False),
    "no offer: scores and vote only (timing only)": (
        [(OFFER, "      if (rounds && a.k < 0) {")], {}, False),
    "no flush: full buffers emptied unmerged (timing only)": (
        [(FLUSH, "if (k < 0) " + FLUSH)], {}, False),
    "no shared bound": ([(BOUND_TEST, "beats"), (BOUND_THR, "fmaxf(st.thr_s()[sr], above_neg_inf)")],
                        {}, True),
    "profile: cycles by phase (timing only)": (PROFILE, {}, False),
    "staging loads batched": ([(STAGING, STAGING_BATCHED)], {}, True),
    "flush through topk_merge.cuh (each entry ranked in a pass of its own and the walk unpipelined)": (
        [(SORT, ""), (FLUSH, "flush_row_inline<kBufCap>(stage_s")], {}, True),
    "offer rounds unrolled (no switch)": ([(ROUNDS, ROUNDS_UNROLLED)], {}, True),
    "flush by the warpgroup's half-warps together": (GROUP_FLUSH, {}, True),
    "3 ring stages": ([], {"TC_STAGES": (3,)}, True),
    "4 ring stages": ([], {"TC_STAGES": (4, 3)}, True),
    "5 ring stages": ([], {"TC_STAGES": (5, 4, 3)}, True),
    "6 ring stages": ([], {"TC_STAGES": (6, 5, 4, 3)}, True),
    "4 ring stages and staging loads batched": ([(STAGING, STAGING_BATCHED)],
                                                {"TC_STAGES": (4, 3)}, True),
    "flush at 48 entries": ([(CAP, "constexpr int kCap = 48;")],
                            {"ROW_CAP": 48, "TC_BUF_CAP": 48 + 128}, True),
    "flush at 64 entries": ([(CAP, "constexpr int kCap = 64;")],
                            {"ROW_CAP": 64, "TC_BUF_CAP": 64 + 128}, True),
    "flush at 128 entries": ([(CAP, "constexpr int kCap = 128;")],
                             {"ROW_CAP": 128, "TC_BUF_CAP": 128 + 128}, True),
}
SHAPES = ((64, 30), (64, 300), (256, 30), (256, 300), (1024, 30), (1024, 300))
SOURCES = ("flat_topk_tc.cu", "topk_merge.cuh")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    if not vh.start():
        return 2
    chosen = vh.chosen(VARIANTS, args.only)
    built = vh.build_all(chosen, VARIANTS, SOURCES, ("bf16_tc_pass1",), "variants_tc")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2025)
    N, D = args.rows, 768
    x = torch.empty((N, D), dtype=torch.bfloat16, device=dev)
    for base in range(0, N, 131072):
        n = min(131072, N - base)
        x[base: base + n] = cs._unit(torch, torch.randn(n, D, generator=g, device=dev))
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = cs.NEG_INF
    qs = {B: [cs._unit(torch, torch.randn(B, D, generator=g, device=dev)).to(torch.bfloat16)
              for _ in range(3)] for B in {b for b, _ in SHAPES}}
    ref = {(B, k): topk.streaming_topk(qs[B][0][:4], x, bias, k, tile_n=1 << 17)
           for B, k in SHAPES}
    ms = {n: {} for n in built}
    prof = {n: {} for n in built}
    bad = {n: 0 for n in built}
    k2tc = topk.streaming_topk_cuda_tc

    def run(n):
        profiled = n.startswith("profile")
        if profiled:
            lib = topk._tc_lib()
            lib.flat_topk_tc_profile.argtypes = [ctypes.c_void_p]
            lib.flat_topk_tc_profile.restype = ctypes.c_int
            counts = (ctypes.c_ulonglong * 8)()
            lib.flat_topk_tc_profile(counts)  # zero
        for B, k in SHAPES:
            ms[n].setdefault(f"B={B} k={k}", []).append(
                cs._time_ms(torch, lambda b: k2tc(b, x, bias, k), qs[B]))
            if profiled:  # cycles per consumer warp and launch, by phase
                torch.cuda.synchronize()
                if lib.flat_topk_tc_profile(counts):
                    raise RuntimeError("flat_topk_tc_profile failed")
                per = {ph: counts[i] / max(1, counts[7]) for i, ph in enumerate(PHASES)}
                prof[n].setdefault(f"B={B} k={k}", []).append(per)
            if VARIANTS[n][2]:
                s_k, i_k = k2tc(qs[B][0], x, bias, k)
                e = cs.check_topk(torch, None, None, None, s_k[:4], i_k[:4], *ref[(B, k)],
                                  judge=cs.dot_judge(qs[B][0][:4], x, bias))
                bad[n] += e[2]

    vh.in_turns(built, "flat_topk_tc", topk, run, {n: VARIANTS[n][1] for n in built},
                handle="_tc_lib_handle")
    return vh.report(chosen, built, ms, bad, {n: VARIANTS[n][2] for n in built},
                     {n: {"cycles_per_warp": prof[n]} for n in built if prof[n]})


if __name__ == "__main__":
    sys.exit(main())

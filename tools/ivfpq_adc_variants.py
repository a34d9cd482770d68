#!/usr/bin/env python3
"""Time K8 (`ivfpq_search_cuda`, csrc/ivfpq_adc.cu) against variants of its
design, on one NVIDIA GPU.

    python3 tools/ivfpq_adc_variants.py [--only NAME,NAME] [--shapes B:k,...]
    python3 tools/ivfpq_adc_variants.py --profile [--shapes B:k,...]

A variant is the committed csrc/ivfpq_adc.cu with text changes and
index/ivfpq.py constants, or called with other arguments (no extents),
each built and loaded in place of the shipped library by
tools/variant_harness.py (into codegraph_tpu_torch/_build/variants_adc/).
The cells are
synthetic at the phase-7 shape of chip_smoke.py, made on the card from a
seed: nlist 4096, m 96, ksub 256, cap 4992, D 768, each cell filled to a
uniform depth in [1220, 3660] (about 10M rows), 1% of the rows tombstoned.
Every variant runs at B:k in (1, 8, 256, 1024) x (40, 300), B=64 k=40
and B=1 k=1920 and 5000 by default: median ms over 3 batches (CUDA
events; the call includes the coarse stage and the ADC table), all variants
in turns, forward then backward. Variants marked `timing only` give wrong
top-k on purpose; the others are checked against the plain version on two
rows of one batch. Prints the card, each variant's ptxas lines, and one
JSON line per variant. Exits 1 if a text change no longer applies, a build
fails, or a checked variant disagrees.

--profile builds one copy of the kernels with clock64() stamps instead (the
PROFILE text changes) and prints, for each shape, the cycles a block
spends in each phase (thread 0's view, summed over blocks by atomics) and
the SM clock that %globaltimer gives beside them.
"""

import argparse
import ctypes
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from codegraph_tpu_torch.index import ivfpq  # noqa: E402
from codegraph_tpu_torch.ops import cuda_build  # noqa: E402
from tools import variant_harness as vh  # noqa: E402

QM_OFFER = "bool v = s >= lb && beats(s, id, ts, ti);"
QM_UNROLL = "#pragma unroll 4\n        for (int j = 0; j < m; ++j) {"
QM_TABLE = "const float* tab = table_in_smem ? tab_s : qtab;"
# the --profile build: g_prof[0..3] the blocks' setup and scan cycles, ns,
# block count
PROFILE = [
    ('#include "topk_merge.cuh"\n', '#include "topk_merge.cuh"\n'
     "__device__ unsigned long long g_prof[16];\n"
     "__device__ __forceinline__ unsigned long long gtime() {\n"
     '  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t;\n}\n'),
    ("  const int b = blockIdx.x;\n  const int split = blockIdx.y, S = gridDim.y;",
     "  unsigned long long Q0 = clock64(), QG = gtime();\n"
     "  const int b = blockIdx.x;\n  const int split = blockIdx.y, S = gridDim.y;"),
    ("  for (int t0 = u_begin; t0 < u_end; t0 += kTile) {",
     "  unsigned long long Q1 = clock64();\n  for (int t0 = u_begin; t0 < u_end; t0 += kTile) {"),
    ("  if (c > 0) {\n    flush_row(hb_s, hb_i, c,",
     "  if (tid == 0) {\n    atomicAdd(&g_prof[0], Q1 - Q0); atomicAdd(&g_prof[1], clock64() - Q1);\n"
     "    atomicAdd(&g_prof[2], gtime() - QG); atomicAdd(&g_prof[3], 1ull);\n  }\n"
     "  if (c > 0) {\n    flush_row(hb_s, hb_i, c,"),
]
PROFILE_API = """
extern "C" void prof_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_prof, sizeof(unsigned long long) * 16);
}
extern "C" void prof_reset() {
  unsigned long long z[16] = {0};
  cudaMemcpyToSymbol(g_prof, z, sizeof(z));
}
"""
# name -> (text substitutions, index/ivfpq.py constants, call keywords, checked)
VARIANTS = {
    "shipped": ([], {}, {}, True),
    "whole cap (no extents)": ([], {}, {"extents": None}, True),
    "no offer (timing only)": ([(QM_OFFER, "bool v = s > 1e30f && beats(s, id, ts, ti);")], {},
                               {}, False),
    "code loads unrolled 8": ([(QM_UNROLL, QM_UNROLL.replace("unroll 4", "unroll 8"))], {}, {},
                              True),
    "table read from device memory": ([(QM_TABLE, "const float* tab = qtab;")], {}, {}, True),
    "one code word a warp (timing only)": (
        [("const uint8_t* cp = codes + (size_t)cell * m * cap + col;",
          "const uint8_t* cp = codes + (size_t)cell * m * cap + (col & ~255);")], {}, {}, False),
}
SHAPES = "1:40,1:300,1:1920,1:5000,8:40,8:300,64:40,256:40,256:300,1024:40,1024:300"
SOURCES = ("ivfpq_adc.cu",)
ENTRIES = ("adc_",)  # the kernels whose ptxas lines it prints


def profile(shapes) -> int:
    """The --profile run: cycles a block by phase."""
    ptxas, so = vh.build_one(cuda_build.BUILD_DIR / "variants_adc" / "profile", PROFILE, SOURCES,
                             ENTRIES, PROFILE_API)
    if so is None:
        print(json.dumps({"profile": ptxas}), flush=True)
        return 1
    print(json.dumps({"profile ptxas": ptxas}), flush=True)
    lib = ctypes.CDLL(so)
    lib.prof_read.argtypes = [ctypes.c_void_p]
    cuda_build._loaded["ivfpq_adc"] = lib
    ivfpq._lib_handle = None
    g = torch.Generator(device="cuda").manual_seed(2026)
    *state, fill = cs.synthetic_ivfpq_cells(torch, g)
    for B, k in shapes:
        qb = cs._unit(torch, torch.randn(B, 768, generator=g, device="cuda"))
        ivfpq.ivfpq_search_cuda(qb, *state, k, 64, extents=fill)
        torch.cuda.synchronize()
        lib.prof_reset()
        ivfpq.ivfpq_search_cuda(qb, *state, k, 64, extents=fill)
        torch.cuda.synchronize()
        v = (ctypes.c_ulonglong * 16)()
        lib.prof_read(v)
        row = {"B": B, "k": k}
        if v[3]:
            n = v[3]
            row.update({"blocks": n, "sm_ghz": (v[0] + v[1]) / v[2], "block_us": v[2] / n / 1e3,
                        "cycles_a_block": {"setup": v[0] / n, "scan and offer": v[1] / n}})
        print(json.dumps(row), flush=True)
    cuda_build._loaded.pop("ivfpq_adc", None)
    ivfpq._lib_handle = None
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--profile", action="store_true", help="cycles a block by phase instead")
    args = ap.parse_args()
    if not vh.start():
        return 2
    shapes = [tuple(int(v) for v in s.split(":")) for s in args.shapes.split(",")]
    if args.profile:
        return profile(shapes)
    chosen = vh.chosen(VARIANTS, args.only)
    built = vh.build_all(chosen, VARIANTS, SOURCES, ENTRIES, "variants_adc")

    g = torch.Generator(device="cuda").manual_seed(2026)
    *state, fill = cs.synthetic_ivfpq_cells(torch, g)
    nprobe = 64
    qs = {B: [cs._unit(torch, torch.randn(B, 768, generator=g, device="cuda")) for _ in range(3)]
          for B in {b for b, _ in shapes}}
    ref = {(B, k): ivfpq.ivfpq_search(qs[B][0][:2], *state, k, nprobe) for B, k in shapes}
    ms = {n: {} for n in built}
    bad = {n: 0 for n in built}

    def run(n):
        kw = {"extents": fill, **VARIANTS[n][2]}
        for B, k in shapes:
            fn = lambda qb: ivfpq.ivfpq_search_cuda(qb, *state, k, nprobe, **kw)  # noqa: E731
            ms[n].setdefault(f"B={B} k={k}", []).append(cs._time_ms(torch, fn, qs[B]))
            if VARIANTS[n][3]:
                s_k, i_k = fn(qs[B][0])
                s_r, i_r = ref[(B, k)]
                e = cs.check_topk(torch, None, None, None, s_k[:2], i_k[:2], s_r, i_r,
                                  judge=cs.adc_judge(torch, qs[B][0][:2], *state))
                bad[n] += e[2]

    vh.in_turns(built, "ivfpq_adc", ivfpq, run, {n: VARIANTS[n][1] for n in built})
    for B in sorted({b for b, _ in shapes}):  # the wrapper's PyTorch stages alone
        coarse = cs._time_ms(torch, lambda qb: ivfpq.adc_inputs(qb, state[0], state[4], nprobe),
                             qs[B])
        print(json.dumps({"B": B, "coarse_and_table_ms": coarse}), flush=True)
    return vh.report(chosen, built, ms, bad, {n: VARIANTS[n][3] for n in built})


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time K8 (`ivfpq_search_cuda`, csrc/ivfpq_adc.cu) against variants of its
design, on one NVIDIA GPU.

    python3 tools/ivfpq_adc_variants.py [--only NAME,NAME] [--shapes B:k,...]
    python3 tools/ivfpq_adc_variants.py --profile [--shapes B:k,...]

A variant is the committed csrc/ivfpq_adc.cu with text changes and
index/ivfpq.py constants (built with the same nvcc flags into
codegraph_tpu_torch/_build/variants_adc/, one nvcc each, in parallel, and
loaded in place of the shipped library), or the shipped library called with
other arguments (no extents). The cells are
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
import subprocess
import sys
import threading

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from codegraph_tpu_torch.index import ivfpq  # noqa: E402
from codegraph_tpu_torch.ops import cuda_build  # noqa: E402

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
SOURCE = "ivfpq_adc.cu"


def build(i: int, name: str, out: dict, subs=None, tail: str = "") -> None:
    subs = VARIANTS[name][0] if subs is None else subs
    if not subs:  # built before the threads start
        out[name + "/so"] = str(cuda_build.build("ivfpq_adc"))
        out[name] = "shipped library"
        return
    d = cuda_build.BUILD_DIR / "variants_adc" / str(i)
    d.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC_DIR / SOURCE).read_text()
    for a, b in subs:
        if a not in src:
            out[name] = f"anchor not found: {a!r}"
            return
        src = src.replace(a, b)
    (d / SOURCE).write_text(src + tail)
    for h in cuda_build.CSRC_DIR.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    so = d / "libivfpq_adc.so"
    r = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                        str(d / SOURCE)],
                       capture_output=True, text=True, timeout=cuda_build.BUILD_TIMEOUT_S)
    if r.returncode:
        out[name] = r.stderr[-2000:]
        return
    out[name] = [ln for ln in cs.ptxas_summary(r.stdout + r.stderr) if "adc_" in ln]
    out[name + "/so"] = str(so)


def profile(shapes) -> int:
    """The --profile run: cycles a block by phase."""
    out: dict = {}
    build(99, "profile", out, PROFILE, PROFILE_API)
    if "profile/so" not in out:
        print(json.dumps({"profile": out.get("profile")}), flush=True)
        return 1
    print(json.dumps({"profile ptxas": out["profile"]}), flush=True)
    lib = ctypes.CDLL(out["profile/so"])
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
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    if args.profile:
        return profile([tuple(int(v) for v in s.split(":")) for s in args.shapes.split(",")])
    chosen = [n for n in VARIANTS if not args.only or n in args.only.split(",")]
    shapes = [tuple(int(v) for v in s.split(":")) for s in args.shapes.split(",")]
    built: dict = {}
    cuda_build.build("ivfpq_adc")
    threads = [threading.Thread(target=build, args=(i, n, built)) for i, n in enumerate(chosen)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    names = [n for n in chosen if n + "/so" in built]
    for n in chosen:
        print(json.dumps({"variant": n, "ptxas": built.get(n)}), flush=True)

    g = torch.Generator(device="cuda").manual_seed(2026)
    *state, fill = cs.synthetic_ivfpq_cells(torch, g)
    nprobe = 64
    qs = {B: [cs._unit(torch, torch.randn(B, 768, generator=g, device="cuda")) for _ in range(3)]
          for B in {b for b, _ in shapes}}
    ref = {(B, k): ivfpq.ivfpq_search(qs[B][0][:2], *state, k, nprobe) for B, k in shapes}
    saved = {a: getattr(ivfpq, a) for a in {c for v in VARIANTS.values() for c in v[1]}}
    ms = {n: {} for n in names}
    bad = {n: 0 for n in names}
    for n in names + names[::-1]:
        cuda_build._loaded["ivfpq_adc"] = ctypes.CDLL(built[n + "/so"])
        ivfpq._lib_handle = None
        for a, v in {**saved, **VARIANTS[n][1]}.items():
            setattr(ivfpq, a, v)
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
    cuda_build._loaded.pop("ivfpq_adc", None)
    ivfpq._lib_handle = None
    for a, v in saved.items():
        setattr(ivfpq, a, v)
    for B in sorted({b for b, _ in shapes}):  # the wrapper's PyTorch stages alone
        coarse = cs._time_ms(torch, lambda qb: ivfpq.adc_inputs(qb, state[0], state[4], nprobe),
                             qs[B])
        print(json.dumps({"B": B, "coarse_and_table_ms": coarse}), flush=True)
    for n in names:
        print(json.dumps({"variant": n, "ms": ms[n],
                          "mismatches_outside_ties": bad[n] if VARIANTS[n][3] else "not checked"}),
              flush=True)
    if len(names) < len(chosen):
        print(f"not timed (no anchor or no build): {sorted(set(chosen) - set(names))}",
              file=sys.stderr, flush=True)
        return 1
    return 0 if all(v == 0 for n, v in bad.items() if VARIANTS[n][3]) else 1


if __name__ == "__main__":
    sys.exit(main())

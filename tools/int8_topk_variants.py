#!/usr/bin/env python3
"""Time K6 (`streaming_topk_int8_cuda_qmajor`, csrc/int8_topk.cu
`int8_tc_pass1`) against variants of its design, on one NVIDIA GPU.

    python3 tools/int8_topk_variants.py [--rows 10000000] [--only NAME,NAME]

Each variant is the committed csrc/int8_topk.cu and csrc/topk_merge.cuh with
its text changes and ops/quantize.py constants (below), built with the same
nvcc flags into codegraph_tpu_torch/_build/variants_int8/ (one nvcc each, in
parallel) and loaded in place of the shipped library. On a 1% tombstoned
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
from codegraph_tpu_torch.ops import cuda_build, quantize  # noqa: E402

EPILOGUE = "      // The epilogue. acc[4j + 2h + e]"
OFFER = "      if (rounds) {"
BOUND_TEST = "s >= lb[h] && beats"
BOUND_THR = "fmaxf(fmaxf(st.thr_s()[sr], st.bnd()[sr]), above_neg_inf)"
FLUSH = "flush_row_inline<kBufCap>(stage_s"
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
}
SHAPES = ((64, 100), (64, 300), (256, 100), (256, 300), (1024, 100), (1024, 300))
SOURCES = ("int8_topk.cu", "topk_merge.cuh")


def build(i: int, name: str, out: dict) -> None:
    d = cuda_build.BUILD_DIR / "variants_int8" / str(i)
    d.mkdir(parents=True, exist_ok=True)
    srcs = {f: (cuda_build.CSRC_DIR / f).read_text() for f in SOURCES}
    for a, b in VARIANTS[name][0]:
        hit = [f for f in SOURCES if a in srcs[f]]
        if not hit:
            out[name] = f"anchor not found: {a!r}"
            return
        srcs[hit[0]] = srcs[hit[0]].replace(a, b)
    for f, text in srcs.items():
        (d / f).write_text(text)
    so = d / "libint8_topk.so"
    r = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                        str(d / "int8_topk.cu")],
                       capture_output=True, text=True, timeout=cuda_build.BUILD_TIMEOUT_S)
    if r.returncode:
        out[name] = r.stderr[-2000:]
        return
    out[name] = [ln for ln in cs.ptxas_summary(r.stdout + r.stderr)
                 if ln.startswith("int8_tc_pass1")]
    out[name + "/so"] = str(so)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    chosen = [n for n in VARIANTS if not args.only or n in args.only.split(",")]
    built: dict = {}
    threads = [threading.Thread(target=build, args=(i, n, built)) for i, n in enumerate(chosen)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    names = [n for n in chosen if n + "/so" in built]
    for n in chosen:
        print(json.dumps({"variant": n, "ptxas": built.get(n)}), flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2025)
    N, D = args.rows, 768
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
    saved = {a: getattr(quantize, a)
             for a in ("TC_STAGES", "ROW_CAP", "TC_BUF_CAP")}
    ms = {n: {} for n in names}
    bad = {n: 0 for n in names}
    k6 = quantize.streaming_topk_int8_cuda_qmajor
    for n in names + names[::-1]:
        cuda_build._loaded["int8_topk"] = ctypes.CDLL(built[n + "/so"])
        quantize._lib_handle = None
        for a, v in {**saved, **VARIANTS[n][1]}.items():
            setattr(quantize, a, v)
        for B, k in SHAPES:
            ms[n].setdefault(f"B={B} k={k}", []).append(
                cs._time_ms(torch, lambda b: k6(b[0], b[1], xv, xs, bias, k), qs[B]))
            if VARIANTS[n][2]:
                s_k, i_k = k6(*qs[B][0], xv, xs, bias, k)
                args4 = (qs[B][0][0][:4], qs[B][0][1][:4], xv, xs, bias)
                e = cs.check_topk(torch, None, None, None, s_k[:4], i_k[:4], *ref[(B, k)],
                                  judge=cs.int8_judge(*args4))
                bad[n] += e[2] + int(((s_k[:4] != ref[(B, k)][0]) & (ref[(B, k)][0] > cs.NEG_INF / 2)).sum())
    cuda_build._loaded.pop("int8_topk", None)
    quantize._lib_handle = None
    for a, v in saved.items():
        setattr(quantize, a, v)
    for n in names:
        print(json.dumps({"variant": n, "ms": ms[n],
                          "mismatches_outside_ties": bad[n] if VARIANTS[n][2] else "not checked"}),
              flush=True)
    if len(names) < len(chosen):
        print(f"not timed (no anchor or no build): {sorted(set(chosen) - set(names))}",
              file=sys.stderr, flush=True)
        return 1
    return 0 if all(v == 0 for n, v in bad.items() if VARIANTS[n][2]) else 1


if __name__ == "__main__":
    sys.exit(main())

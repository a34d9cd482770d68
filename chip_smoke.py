#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`codegraph_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                  # all phases, one card
    python3 chip_smoke.py --phases 0,1     # build + kernel checks only
    python3 chip_smoke.py --phases 0,4,5   # the int8 tier only
    python3 chip_smoke.py --phases 0,1,6,7 # the IVF tiers (K8) only
    python3 chip_smoke.py --phases 0,8     # the default configuration only

Phases, each printing one JSON object per line as it ends:

  0  card name and power limit, torch and nvcc versions; builds the CUDA
     sources from csrc/ (flat_topk.cu, int8_topk.cu, ivfpq_adc.cu and the
     host helper ivf_spill.cu, one nvcc each, in parallel) and prints the
     build seconds and the ptxas line (registers, spills) of every kernel
     instance.
  1  every kernel against its plain PyTorch version on the card. K1, K2
     and K3: f32 and bf16 corpora up to 131,072 x 768, k in {1, 10, 30,
     100, 300, 1024}, K2-K4 at B = 20, 31 and 32 (a 32-row query tile), 33,
     40 and 64 (a 64-row tile) and 70, 96, 256 and 1000 (partial 128-row
     tiles). K5, K6 and K7: int8 corpora of the same sizes, k in {1, 10,
     100, 300}, with an all-zero row (scale 0) and rows of +-127 everywhere
     (an int8 wrap would show), K6 at B = 33, 64 (the 64-row tile), 65,
     96, 128, 129, 255, 256 and 1000 (128-row tiles), K7 at 64, 96, 129
     and 256, and K6 at D = 100 (not a multiple of 16: the mma.sync kernel,
     K6s), its scores equal to the plain version's bit for bit. Both: a
     ragged N, 1% tombstones, an
     extra_bias filter, k above the live count, duplicate rows (exact
     ties), batches on both sides of 32. K4: K2's cases on xt = x.T. K8:
     synthetic IVF-PQ cells filled to random depths (the fills passed as
     extents, and once not), m in {6, 16, 96}, ksub in {16, 256}, nprobe in
     {1, 8, 32, 64, nlist}, k from 1 to 20,000 (above the live probed
     slots, above pass 2's shared memory: a pairwise merge in device
     memory), 1% tombstones, duplicate slots (exact ties), one cell probed
     by every query of a batch of up to 600, and extents outside [0, cap]
     (clipped); the shared-memory plan against index/ivfpq.py; and the
     compiled spill
     placement against the Python loop on overflowing cells. Fails on any
     id mismatch outside ties.
  2  the main path: CodeGraph.open(<copy of codegraph_tpu/>, device="cuda")
     with the hash provider at D=768, .index(), .search() for 5 queries
     (checked against the same snapshot searched on the CPU), then 64
     concurrent queries through QueryService (checked against single
     queries). Prints the counts and the kernels' launch counters, which
     must both be above zero.
  3  real size: FlatIndex of 1,000,000 x 768 rows, f32 then bf16, made on
     the card from a seeded generator, 1% tombstoned; K1 at B=1 and 8,
     k=30 and 300; K2 (f32) at B=32 and 64 (QueryService's bucket), k=30
     and 300; K2, K3 and K4 (f32; K4 on xt = x.T) at B=256 and 1024, k=30,
     100 and 300; K2 (bf16) at B=256 and 1024, k=30 and 300: median kernel
     ms over 7 batches (CUDA events), the plain version's ms, a chunked
     matmul + topk yardstick (library_ms, checked against), and the bound.
  4  the int8 main path: phase 2 with index.dtype = "int8" (Int8FlatIndex,
     bf16 rescore copy): 5 searches (K5) and 64 concurrent queries through
     QueryService (K6), checked against the same snapshot searched on the
     CPU and against single queries; then CodeGraph.open with an
     index.capacity that the planner sends to the int8 tier on this card.
  5  real size of the int8 tier: Int8FlatIndex of 10,000,000 x 768 rows
     with a bf16 rescore copy (about 23 GB), made on the card, 1%
     tombstoned; K5 at B=1 and 8, K6 and K7 at B=64, 256 and 1024, k=100
     and 300, and the mma.sync kernel (K6s) at B=1024, k=100, timed as in
     phase 3 against a chunked torch._int_mm + topk yardstick; and
     Int8FlatIndex.search end to end at B=1 and 1024, with the time of
     each of its stages at B=1024 (quantize, scan, rescore, copy back).
  6  the IVF-PQ main path: phase 2 with index.kind = "ivfpq" at the config
     defaults (nlist 4096, nprobe 64, pq_m 96, host int8 refine): 5
     searches, a filtered search keeping <= 3% of rows (a fetch above
     1,024), 64 concurrent queries through QueryService, each checked
     against the same snapshot on the CPU or against single queries; K8
     must launch and no flat or int8 kernel. Then index.kind = "ivf" (no
     kernel), and CodeGraph.open with an index.capacity that the planner
     sends to IVF-PQ on this card.
  7  real size of the IVF-PQ tier: IVFPQIndex(768, nlist 4096, nprobe 64,
     m 96, refine "int8_device") over 10,000,000 rows of a clustered
     mixture made on the card, 1% tombstoned; build seconds by stage and
     card memory; K8 at B=1, 8, 256, 1024 and k=40, 300 (and B=1 k=1920,
     phase 6's filtered fetch), with the cells' fills as extents and over
     their whole cap, against its plain version, the batch-shared route
     (library_ms) and its bound, with the time of the coarse stage and ADC
     table, the lookup floor and the code bytes it reads;
     IVFPQIndex.search end to end at B=1 and 1024 and its recall@10
     against an exact f32 scan.
  8  the default configuration: CodeGraph.open(<copy of codegraph_tpu/>,
     CodeGraphConfig() with only data_dir set, device="cuda"), which must
     resolve to the pipeline [ensemble, hash] with the encoder of
     checkpoints/encoder_r3_512.npz and its BPE-16k tokenizer on the card;
     .index() (stage seconds, the encoder's host tokenization apart from
     its forward, texts/s, tokens/s; the hash member must embed nothing
     and no provider fail), 5 searches (K1) and 64 QueryService queries
     (K2; no other kernel may launch), checked as in phase 2; the encoder
     against the JAX package's golden embeddings (tests/data/
     encoder_r3_golden.npz) and against its CPU path, within 2e-3, and one
     forward timed at B=1 x 64 and 256 x 192 tokens; the same snapshot
     loaded on the CPU: hybrid hits with the card's query vectors (1e-5)
     and with each side's own (2e-3), and one semantic_code_search tool
     call with the default feature reranker (2e-3).

Then the card's name and power limit, one JSON line with every kernel's
numbers, and last {"ok": true, "device": {...}}. Any failed check exits
non-zero before that line. The JAX package is read as text (phase 2's
corpus), never imported.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WATCHDOG_S = 900
NEG_INF = -1e30

# H100 SXM data sheet (dense): the bound of a kernel is the larger of its
# bytes over the memory rate and its operations over the peak rate of its type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

# Scores of unit-norm rows and queries lie in [-1, 1]. f32 sums taken in
# another order differ by ~1e-7 at D=768; bf16 rows and queries multiply
# exactly in f32, so both dtypes are held to the same bound.
SCORE_TOL = 1e-5

#: the sources under codegraph_tpu_torch/csrc/, built in phase 0
SOURCES = ("flat_topk", "int8_topk", "ivfpq_adc", "ivf_spill")


# name -> (wrapper module, wrapper, source, line of the TPU kernel's pallas_call)
FLAT_CU = "codegraph_tpu_torch/csrc/flat_topk.cu"
INT8_CU = "codegraph_tpu_torch/csrc/int8_topk.cu"
IVFPQ_CU = "codegraph_tpu_torch/csrc/ivfpq_adc.cu"
KERNELS = {
    "K1": ("topk", "streaming_topk_cuda", FLAT_CU, "codegraph_tpu/ops/topk.py:347"),
    "K2": ("topk", "streaming_topk_cuda_qmajor", FLAT_CU, "codegraph_tpu/ops/topk.py:456"),
    "K3": ("topk", "streaming_topk_cuda_qres", FLAT_CU, "codegraph_tpu/ops/topk.py:561"),
    "K4": ("topk", "streaming_topk_cuda_qmajor_xt", FLAT_CU, "codegraph_tpu/ops/topk.py:664"),
    "K5": ("quantize", "streaming_topk_int8_cuda", INT8_CU, "codegraph_tpu/ops/quantize.py:182"),
    "K6": ("quantize", "streaming_topk_int8_cuda_qmajor", INT8_CU,
           "codegraph_tpu/ops/quantize.py:287"),
    "K7": ("quantize", "streaming_topk_int8_cuda_qres", INT8_CU,
           "codegraph_tpu/ops/quantize.py:396"),
    # K6/K7 on the shapes TMA cannot take (D % 16 != 0, unaligned rows)
    "K6s": ("quantize", "streaming_topk_int8_cuda_sync", INT8_CU,
            "codegraph_tpu/ops/quantize.py:287"),
    "K8": ("ivfpq", "ivfpq_search_cuda", IVFPQ_CU, "codegraph_tpu/index/ivfpq.py:273"),
}


def wrapper(mods, name):
    module, fn, _, _ = KERNELS[name]
    return getattr(mods[module], fn)


def reset_launches(mods) -> None:
    """Every kernel's launch count to 0: called just before a main path."""
    for name in KERNELS:
        wrapper(mods, name).launches = 0


def read_launches(mods) -> dict:
    """Every kernel's launch count: read just after a main path."""
    return {name: wrapper(mods, name).launches for name in KERNELS}


class CheckFailed(Exception):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# checking a top-k result against a reference
# ---------------------------------------------------------------------------


def dot_judge(q, x, bias):
    """True scores of rows of x for query b: the dot product in f64 + bias."""
    return lambda b, rows: (x[rows].double() @ q[b].double()) + bias[rows].double()


def int8_judge(qv, qs, xv, xs, bias):
    """True scores of int8 rows for query b as the reference rounds them:
    the exact integer dot, then * qs[b], * xs[n], + bias[n] in f32."""
    def judge(b, rows):
        raw = (xv[rows].double() @ qv[b].double()).float()
        return (raw * qs[b] * xs[rows] + bias[rows]).double()
    return judge


def check_topk(torch, q, x, bias, s_k, i_k, s_ref, i_ref, tol=SCORE_TOL, judge=None):
    """Hold (s_k, i_k) to the reference (s_ref, i_ref), tie-aware.

    Sentinel (NEG_INF) positions must agree; live scores must agree within
    tol; live ids must be distinct per row; and where an id differs from
    the reference's, the row it names must score (recomputed by `judge`,
    by default the f64 dot product of q and x plus bias) within tol of the
    reference score at that position, i.e. it is tied.
    Returns (max_abs_err, id_mismatches, mismatches_outside_ties)."""
    judge = judge or dot_judge(q, x, bias)
    live_k = s_k > NEG_INF / 2
    live_r = s_ref > NEG_INF / 2
    bad = int((live_k != live_r).sum())
    bad += int(((~live_k) & (i_k != -1)).sum())
    both = live_k & live_r
    err = float((s_k - s_ref).abs()[both].max()) if bool(both.any()) else 0.0
    differ = (i_k != i_ref) & both
    n_differ = int(differ.sum())
    for b in range(s_k.shape[0]):
        ids = i_k[b][live_k[b]]
        if ids.numel() and torch.unique(ids).numel() != ids.numel():
            bad += 1
        if bool(differ[b].any()):
            pos = differ[b].nonzero().flatten()
            true = judge(b, i_k[b][pos].long())
            bad += int(((true - s_ref[b][pos].double()).abs() > tol).sum())
    if err > tol:
        bad += 1
    return err, n_differ, bad


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase0(torch) -> dict:
    from codegraph_tpu_torch.ops import cuda_build

    smi = nvidia_smi_line()
    nvcc = cuda_build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    cuda_build.build_all(SOURCES)
    build_s = time.perf_counter() - t0
    ptxas = [f"{name}: {line}" for name in SOURCES for line in ptxas_summary(cuda_build.build_log(name))]
    out = {"phase": 0, "gpu": smi, "torch": torch.__version__,
           "torch_cuda": torch.version.cuda, "nvcc": ver,
           "build_seconds": round(build_s, 3), "ptxas": ptxas}
    emit(out)
    return out


def ptxas_summary(log: str) -> list:
    """One line per kernel of `nvcc -Xptxas=-v` output: its (mangled,
    shortened) name, registers and spill bytes."""
    out, name, spill = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"(topk_pass1|rows_pass1|int8_dp4a_pass1|int8_mma_pass1|int8_tc_pass1|adc_qmajor|"
                          r"merge_pairs_global|"
                          r"topk_merge)"
                          r"(I\w*?EE)?",
                          m.group(1))
            name = k.group(1) + (k.group(2) or "") if k else m.group(1)
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers; {spill}")
    return out


def _unit(torch, t):
    return t / t.float().norm(dim=1, keepdim=True).clamp(min=1e-6).to(t.dtype)


def phase1(torch, mods, errs) -> dict:
    topk, quantize = mods["topk"], mods["quantize"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    D = 768
    cases = []
    flat = {"K1": topk.streaming_topk_cuda, "K2": topk.streaming_topk_cuda_qmajor,
            "K3": topk.streaming_topk_cuda_qres}
    k4 = topk.streaming_topk_cuda_qmajor_xt
    int8 = {"K5": quantize.streaming_topk_int8_cuda, "K6": quantize.streaming_topk_int8_cuda_qmajor,
            "K7": quantize.streaming_topk_int8_cuda_qres}
    # (N, duplicate rows, filter, live rows)
    corpora = ((131072, False, False, None), (100003, True, True, None), (200, False, False, 150))
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        for N, dup, filt, live in corpora:
            x = _unit(torch, torch.randn(N, D, generator=g, device=dev))
            bias = torch.zeros(N, device=dev)
            dead = torch.randperm(N, generator=g, device=dev)[: max(1, N // 100)]
            bias[dead] = NEG_INF
            if live is not None:
                bias[live:] = NEG_INF
            if filt:  # extra_bias: a filter excluding ~10% of rows
                flt = torch.rand(N, generator=g, device=dev) < 0.1
                bias = bias + torch.where(flt, NEG_INF, 0.0)
            if dtype == torch.int8:
                xv, xs = quantize.quantize_rows(x)
                xv[17] = 0  # an all-zero row: scale 0
                xs[17] = 0.0
                xv[20:25] = 127  # +-127 everywhere: an int8 product would wrap
                xv[25:30] = -127
                xs[20:30] = 1.0 / 127
                if dup:  # exact ties: rows 1000..1999 repeat rows 0..999
                    xv[1000:2000] = xv[0:1000]
                    xs[1000:2000] = xs[0:1000]
                kernels, ks = int8, (1, 10, 100, 300)
            else:
                x = x.to(dtype)
                if dup:
                    x[1000:2000] = x[0:1000]
                xt = x.T.contiguous()  # K4's corpus: the same rows as xt [D, N]
                kernels, ks = dict(flat, K4=lambda q_, x_, b_, k_: k4(q_, xt, b_, k_)), \
                    (1, 10, 30, 100, 300, 1024)
            # (kernel, batch); the int8 tier names K5-K7 like K1-K3
            layouts = (("K1", 1), ("K1", 5), ("K2", 96), ("K2", 256), ("K3", 96), ("K3", 256))
            if dtype != torch.int8:  # the row tiles: 32-, 64- and partial 128-row query tiles
                layouts += (("K2", 20), ("K2", 33), ("K2", 64), ("K2", 70), ("K2", 1000),
                            ("K3", 32), ("K3", 40), ("K3", 70), ("K3", 1000), ("K4", 31),
                            ("K4", 64), ("K4", 70), ("K4", 96), ("K4", 256), ("K4", 1000))
            else:  # both sides of K6/K7's 64- and 128-row query tiles
                layouts += (("K2", 33), ("K2", 64), ("K2", 65), ("K2", 128), ("K2", 129),
                            ("K2", 255), ("K2", 1000), ("K3", 64), ("K3", 129))
            for kernel, B in layouts:
                if dtype == torch.int8:
                    kernel = {"K1": "K5", "K2": "K6", "K3": "K7"}[kernel]
                fn = kernels[kernel]
                q = _unit(torch, torch.randn(B, D, generator=g, device=dev))
                if dtype == torch.int8:
                    qv, qs = quantize.quantize_rows(q)
                    if dup:
                        qv[0], qs[0] = xv[5], xs[5]  # its own duplicate pair tops the list
                    if B > 1:
                        qv[1] = 127  # against the +-127 rows: 127^2 * D exactly
                        qs[1] = 1.0 / 127
                    args = (qv, qs, xv, xs, bias)
                    plain = quantize.streaming_topk_int8
                    judge = int8_judge(*args)
                else:
                    q = q.to(dtype)
                    if dup:
                        q[0] = x[5]
                    args = (q, x, bias)
                    plain = topk.streaming_topk
                    judge = dot_judge(q, x, bias)
                for k in ks:
                    s_k, i_k = fn(*args, k)
                    torch.cuda.synchronize()
                    s_p, i_p = plain(*args, k)
                    err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                                  judge=judge)
                    if dtype == torch.int8:  # same f32 operations in the same order
                        bad += int(((s_k != s_p) & (s_p > NEG_INF / 2)).sum())
                    errs[kernel] = max(errs[kernel], err)
                    cases.append({
                        "kernel": kernel, "dtype": str(dtype)[6:], "N": N, "B": B,
                        "k": k, "dup": dup, "filter": filt, "live": live or N,
                        "max_abs_err": err, "id_mismatches": n_diff,
                        "mismatches_outside_ties": bad})
    cases += phase1_unaligned(torch, mods, errs, g)
    cases += phase1_k8(torch, mods, errs)
    spill = phase1_spill(mods)
    n_bad = sum(c["mismatches_outside_ties"] for c in cases)
    out = {"phase": 1, "cases": len(cases), "spill_compiled_vs_python": spill,
           "max_abs_err": {k: v for k, v in errs.items()},
           "id_mismatches": sum(c["id_mismatches"] for c in cases),
           "mismatches_outside_ties": n_bad,
           "failed": [c for c in cases if c["mismatches_outside_ties"]][:10]}
    emit(out)
    require(n_bad == 0, f"phase 1: {n_bad} mismatches outside ties")
    require(spill["equal"], "phase 1: the compiled spill placement differs from the Python loop")
    return out


def phase1_unaligned(torch, mods, errs, g) -> list:
    """K6 and K7 at a D that is not a multiple of 16: their wrappers send
    it to the mma.sync kernel (K6s), which must then have launched."""
    quantize = mods["quantize"]
    dev = torch.device("cuda")
    N, D = 20011, 100
    xv, xs = quantize.quantize_rows(_unit(torch, torch.randn(N, D, generator=g, device=dev)))
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = NEG_INF
    cases = []
    before = quantize.streaming_topk_int8_cuda_sync.launches
    for name, B in (("K6", 70), ("K6", 129), ("K7", 40)):
        qv, qs = quantize.quantize_rows(_unit(torch, torch.randn(B, D, generator=g, device=dev)))
        args = (qv, qs, xv, xs, bias)
        for k in (1, 10, 100, 300):
            s_k, i_k = wrapper(mods, name)(*args, k)
            torch.cuda.synchronize()
            s_p, i_p = quantize.streaming_topk_int8(*args, k)
            err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                          judge=int8_judge(*args))
            bad += int(((s_k != s_p) & (s_p > NEG_INF / 2)).sum())
            errs["K6s"] = max(errs["K6s"], err)
            cases.append({"kernel": f"K6s (via {name})", "dtype": "int8", "N": N, "D": D, "B": B,
                          "k": k, "max_abs_err": err, "id_mismatches": n_diff,
                          "mismatches_outside_ties": bad})
    require(quantize.streaming_topk_int8_cuda_sync.launches - before == len(cases),
            "phase 1: K6/K7 at D % 16 != 0 did not run the mma.sync kernel")
    return cases


def ivfpq_state(torch, g, nlist, m, ksub, D, cap, dup=False):
    """Synthetic IVF-PQ cells on the card: unit centroids, small random
    codebooks, cells filled to random depths with unique row ids, 1% of
    the rows tombstoned; with dup, slots 8..15 of every cell repeat slots
    0..7 (the same codes in the same cell: exact ties, other ids)."""
    dev = torch.device("cuda")
    centroids = _unit(torch, torch.randn(nlist, D, generator=g, device=dev))
    books = 0.1 * torch.randn(m, ksub, D // m, generator=g, device=dev)
    codes = torch.randint(0, ksub, (nlist, m, cap), generator=g, device=dev).to(torch.uint8)
    fill = torch.randint(cap // 4, cap + 1, (nlist,), generator=g, device=dev)
    if dup:
        fill = torch.clamp(fill, min=16)
        codes[:, :, 8:16] = codes[:, :, 0:8]
    used = torch.arange(cap, device=dev)[None, :] < fill[:, None]
    n = int(used.sum())
    ids = torch.full((nlist, cap), -1, dtype=torch.int32, device=dev)
    ids[used] = torch.randperm(n, generator=g, device=dev).to(torch.int32)
    bias = torch.where(used, 0.0, NEG_INF).float()
    dead = torch.rand(nlist, cap, generator=g, device=dev) < 0.01
    bias[dead & used] = NEG_INF
    return centroids, codes, ids, bias, books


def synthetic_ivfpq_cells(torch, g, nlist=4096, m=96, ksub=256, cap=4992, D=768):
    """Synthetic IVF-PQ cells at phase 7's shape (its list_cap), for the K8
    tools: each cell filled to a uniform depth in [cap / 4, 3 cap / 4]
    (about 10M rows at the defaults), random codes and codebooks, 1% of the
    rows tombstoned. (centroids, codes, ids, bias, books, fill)."""
    dev = torch.device("cuda")
    centroids = _unit(torch, torch.randn(nlist, D, generator=g, device=dev))
    books = 0.1 * torch.randn(m, ksub, D // m, generator=g, device=dev)
    codes = torch.randint(0, ksub, (nlist, m, cap), generator=g, device=dev, dtype=torch.uint8)
    fill = torch.randint(cap // 4, 3 * cap // 4 + 1, (nlist,), generator=g, device=dev)
    used = torch.arange(cap, device=dev)[None, :] < fill[:, None]
    ids = torch.full((nlist, cap), -1, dtype=torch.int32, device=dev)
    ids[used] = torch.randperm(int(used.sum()), generator=g, device=dev).to(torch.int32)
    bias = torch.where(used, 0.0, NEG_INF).float()
    dead = torch.rand(nlist, cap, generator=g, device=dev) < 0.01
    bias[dead & used] = NEG_INF
    return centroids, codes, ids, bias, books, fill.to(torch.int32).contiguous()


def adc_judge(torch, q, centroids, codes, ids, bias, books):
    """True scores of row ids for query b: the coarse dot plus the ADC of
    the row's codes plus its bias, in f64 (the kernel's function)."""
    nlist, m, cap = codes.shape
    loc = torch.full((int(ids.max()) + 2,), -1, dtype=torch.long, device=ids.device)
    live = ids >= 0
    loc[ids[live].long()] = torch.arange(nlist * cap, device=ids.device).view(nlist, cap)[live]
    dsub = books.shape[2]

    def judge(b, rows):
        cells, pos = loc[rows] // cap, loc[rows] % cap
        qb = q[b].double()
        table = (qb.view(m, dsub)[:, None, :] * books.double()).sum(-1)  # [m, ksub]
        cds = codes[cells, :, pos].long()                                  # [n, m]
        adc = table[torch.arange(m, device=q.device)[None, :], cds].sum(-1)
        return centroids[cells].double() @ qb + adc + bias[cells, pos].double()
    return judge


def phase1_k8(torch, mods, errs) -> list:
    """K8 against its plain version on synthetic cells, with the cells'
    fills as extents (and once without); the shared-memory plan against
    its Python counterpart."""
    ivfpq = mods["ivfpq"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    lib = ivfpq._lib()
    cases = []
    smem = [(lib.ivfpq_qmajor_smem(m, ks, npb, t), ivfpq.qmajor_smem(m, ks, npb, t))
            for m, ks, npb, t in ((96, 256, 64, 1), (96, 256, 4096, 0), (6, 16, 1, 1))]
    smem.append((lib.ivfpq_merge_max_k(), ivfpq.MERGE_MAX_K))
    # (the plan check counts as a case without mismatches: it fails the
    # phase on the spot)
    cases.append({"kernel": "K8", "check": "shared-memory plan vs the .cu", "pairs": smem,
                  "id_mismatches": 0, "mismatches_outside_ties": 0})
    require(all(a == b for a, b in smem), f"phase 1: K8 plan disagrees with the .cu: {smem}")
    # (nlist, m, ksub, D, cap, hot, [(nprobe, B, k), ...]); hot: every query
    # near centroid 0, so that one cell is probed by all of them
    states = (
        (256, 96, 256, 768, 512, False,
         [(1, 1, 1), (1, 600, 10), (1, 1, 1920), (8, 7, 10), (8, 600, 40), (8, 7, 300),
          (64, 1, 40), (64, 7, 300), (64, 300, 40), (64, 1, 1920), (64, 2, 5000),
          (64, 2, 20000), (256, 1, 10), (256, 300, 1920)]),
        (256, 96, 256, 768, 512, True, [(8, 600, 40), (8, 300, 300), (64, 40, 1), (1, 600, 300)]),
        (64, 16, 16, 768, 256, False, [(1, 1, 1), (8, 520, 40), (64, 1, 300), (64, 260, 10)]),
        (32, 6, 256, 48, 128, False, [(8, 3, 10), (32, 600, 300), (32, 3, 40), (1, 513, 1)]),
    )
    for si, (nlist, m, ksub, D, cap, hot, shapes) in enumerate(states):
        state = ivfpq_state(torch, g, nlist, m, ksub, D, cap, dup=True)
        centroids, codes, ids, bias, books = state
        fill = (ids >= 0).sum(1).to(torch.int32).contiguous()
        qs = _unit(torch, torch.randn(600, D, generator=g, device=dev))
        if hot:
            qs = _unit(torch, centroids[0] + 0.02 * qs)
        qs[1] = centroids[0]  # probes cell 0 first: its duplicate slots tie
        judge = adc_judge(torch, qs, *state)
        for nprobe, B, k in shapes:
            q = qs[:B].contiguous()
            s_p, i_p = ivfpq.ivfpq_search(q, centroids, codes, ids, bias, books, k, nprobe)
            for ext in ((fill, None) if si == 0 else (fill,)):
                s_k, i_k = ivfpq.ivfpq_search_cuda(q, centroids, codes, ids, bias, books, k,
                                                   nprobe, extents=ext)
                torch.cuda.synchronize()
                err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                              judge=judge)
                errs["K8"] = max(errs["K8"], err)
                live = int((s_p > NEG_INF / 2).sum(dim=1).min())
                cases.append({"kernel": "K8", "nlist": nlist, "m": m, "ksub": ksub, "cap": cap,
                              "hot_cell": hot, "nprobe": nprobe, "B": B, "k": k,
                              "extents": ext is not None, "min_live_results": live,
                              "max_abs_err": err, "id_mismatches": n_diff,
                              "mismatches_outside_ties": bad})
    # extents outside [0, cap] are clipped: negative on emptied cells, past
    # cap on the others, the same result as the plain version
    centroids, codes, ids, bias, books = ivfpq_state(torch, g, 64, 16, 256, 128, 256)
    ids[:8], bias[:8] = -1, NEG_INF
    fill = (ids >= 0).sum(1).to(torch.int32)
    ext = torch.where(fill == 0, -9, fill + 10_000).to(torch.int32).contiguous()
    q = _unit(torch, torch.randn(520, 128, generator=g, device=dev))
    q[:4] = centroids[:4]  # probe the emptied cells first
    s_p, i_p = ivfpq.ivfpq_search(q, centroids, codes, ids, bias, books, 40, 16)
    s_k, i_k = ivfpq.ivfpq_search_cuda(q, centroids, codes, ids, bias, books, 40, 16, extents=ext)
    torch.cuda.synchronize()
    err, n_diff, bad = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                  judge=adc_judge(torch, q, centroids, codes, ids, bias, books))
    errs["K8"] = max(errs["K8"], err)
    cases.append({"kernel": "K8", "check": "extents outside [0, cap]", "B": 520, "k": 40,
                  "max_abs_err": err, "id_mismatches": n_diff, "mismatches_outside_ties": bad})
    return cases


def phase1_spill(mods) -> dict:
    """The compiled spill placement against the Python loop, on cells that
    overflow (skewed first choices) from a partly filled start."""
    ivf = mods["ivf"]
    rng = np.random.default_rng(9)
    nlist, cap, n = 64, 40, 3000
    top2 = np.stack([rng.zipf(1.6, n) % nlist, rng.integers(0, nlist, n)], 1).astype(np.int32)
    fill0 = rng.integers(0, cap, nlist).astype(np.int64)
    f_py, f_c = fill0.copy(), fill0.copy()
    a_py, p_py = ivf.spill_assign(top2, f_py, cap)
    a_c, p_c = ivf.spill_assign_host(top2, f_c, cap)
    third = int(sum(a != t0 and a != t1 for a, (t0, t1) in zip(a_py, top2)))
    return {"rows": n, "second_or_third_choice": int((a_py != top2[:, 0]).sum()),
            "third_choice": third,
            "equal": bool(np.array_equal(a_py, a_c) and np.array_equal(p_py, p_c)
                          and np.array_equal(f_py, f_c))}


QUERIES = [
    "parse a source file into nodes and edges",
    "streaming top-k kernel over the corpus",
    "hybrid search with bm25 and graph boost",
    "save the index snapshot manifest",
    "resolve call edges between symbols",
]


def phase2(torch, mods, errs) -> dict:
    from codegraph_tpu_torch.api import CodeGraph
    from codegraph_tpu_torch.core.config import CodeGraphConfig
    from codegraph_tpu_torch.search.service import QueryService

    src = os.path.join(ROOT, "codegraph_tpu")
    require(os.path.isdir(src), f"no JAX package source at {src} to index")
    tmp = tempfile.mkdtemp(prefix="cg_smoke_")
    svc = None
    try:
        proj = os.path.join(tmp, "codegraph_tpu")
        shutil.copytree(src, proj, ignore=shutil.ignore_patterns("__pycache__"))
        cfg = CodeGraphConfig()
        cfg.embedding.provider = "hash"
        cfg.embedding.dimension = 768
        cfg.data_dir = os.path.join(tmp, "data")

        topk = mods["topk"]
        reset_launches(mods)
        t0 = time.perf_counter()
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        stats = cg.index()
        t_index = time.perf_counter() - t0

        t0 = time.perf_counter()
        hits = [cg.search(qt, limit=10) for qt in QUERIES]
        t_search = time.perf_counter() - t0

        index = cg.indexer.index
        texts = [f"{QUERIES[i % 5]} variant {i}" for i in range(64)]
        embs = cg.indexer.provider.embed_texts(texts)
        k = 30
        t0 = time.perf_counter()
        svc = QueryService.auto(index, k=k)
        futures = [svc.submit(e) for e in embs]
        batched = [f.result(timeout=120) for f in futures]
        svc.close()
        svc_stats = svc.stats
        svc = None
        t_service = time.perf_counter() - t0
        # the main path ends here; later launches only check results
        launches = read_launches(mods)
        singles = [index.search(e[None, :], k) for e in embs]

        # batched (K2) vs single (K1) results on the same index
        x, bias = index.arrays()
        qn = torch.nn.functional.normalize(torch.as_tensor(embs, device="cuda"), dim=1)
        s_b = torch.as_tensor(np.stack([b[0] for b in batched]), device="cuda")
        i_b = torch.as_tensor(np.stack([b[1] for b in batched]), device="cuda")
        s_1 = torch.as_tensor(np.stack([s[0][0] for s in singles]), device="cuda")
        i_1 = torch.as_tensor(np.stack([s[1][0] for s in singles]), device="cuda")
        err_svc, diff_svc, bad_svc = check_topk(torch, qn, x, bias, s_b, i_b, s_1, i_1)
        errs["K2"] = max(errs["K2"], err_svc)

        # each kernel against its plain version at the main path's shapes
        main_shapes = {}
        for name, fn, B in (("K1", topk.streaming_topk_cuda, 1),
                            ("K2", topk.streaming_topk_cuda_qmajor, 64)):
            s_k, i_k = fn(qn[:B].contiguous(), x, bias, k)
            s_p, i_p = topk.streaming_topk(qn[:B], x, bias, k)
            e, n_d, b_d = check_topk(torch, qn[:B], x, bias, s_k, i_k, s_p, i_p)
            errs[name] = max(errs[name], e)
            main_shapes[name] = {"N": int(x.shape[0]), "B": B, "k": k, "max_abs_err": e,
                                 "id_mismatches": n_d, "mismatches_outside_ties": b_d}

        # the same snapshot searched on the CPU (plain versions) as reference
        cpu = CodeGraph(cfg, device="cpu")
        hybrid = _hybrid_vs_cpu(torch, cg, cpu, hits, k, lambda q: dot_judge(q, x, bias))
        out = {
            "phase": 2, "files": stats.files_total, "nodes": stats.nodes,
            "chunks": stats.chunks, "edges": stats.edges_total,
            "index_rows": index.n_rows, "index_capacity": index.capacity,
            "index_seconds": round(t_index, 3),
            "stage_seconds": {k: round(v, 3) for k, v in stats.stage_seconds.items()},
            "search_seconds_5": round(t_search, 3),
            "search_perf": cg.indexer.search.monitor.report(),
            "service_seconds_64": round(t_service, 3),
            "service_batches": svc_stats.batches, "service_max_batch": svc_stats.max_batch_seen,
            "launches": launches,
            "top1": [h[0].name if h else None for h in hits],
            "service_vs_single": {"max_abs_err": err_svc, "id_mismatches": diff_svc,
                                  "mismatches_outside_ties": bad_svc},
            "hybrid_vs_cpu": hybrid,
            "kernel_vs_plain_main_shapes": main_shapes,
        }
        emit(out)
        require(stats.nodes > 0 and stats.chunks > 0 and stats.edges_total > 0, "empty index")
        require(bad_svc == 0, "phase 2: service results disagree with single queries")
        require(all(v["mismatches_outside_ties"] == 0 for v in main_shapes.values()),
                "phase 2: a kernel disagrees with its plain version at the main path's shapes")
        require(hybrid["mismatches_outside_ties"] == 0,
                "phase 2: CUDA hybrid results disagree with the CPU path")
        require(launches["K1"] > 0 and launches["K2"] > 0,
                f"phase 2: main path did not launch both kernels: {launches}")
        return out
    finally:
        if svc is not None:
            svc.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _time_ms(torch, fn, batches, outs=None):
    """Median ms of fn(batch) over batches (one launch each, CUDA events);
    fn's results are appended to `outs` when it is given."""
    fn(batches[0])  # warm
    times = []
    for qb in batches:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(qb)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        if outs is not None:
            outs.append(out)
    return statistics.median(times)


def yardstick(torch, q, x, bias, k, chunk=131072):
    """Chunked torch.matmul + torch.topk (library calls; used only here)."""
    ss, ii = [], []
    qf = q.float()
    for base in range(0, x.shape[0], chunk):
        s = qf @ x[base: base + chunk].float().T + bias[base: base + chunk]
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        ss.append(v)
        ii.append(i + base)
    s = torch.cat(ss, 1)
    v, p = torch.topk(s, k, dim=1)
    return v, torch.gather(torch.cat(ii, 1), 1, p).int()


def _bound(nbytes: float, ops: float, dtype_name: str):
    """(bound ms, what sets it): bytes over the memory rate or operations
    over the peak rate of the type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase3(torch, topk, errs) -> list:
    from codegraph_tpu_torch.index.flat import FlatIndex

    dev = torch.device("cuda")
    N, D = 1_000_000, 768
    rows_out = []
    for dtype_name in ("float32", "bfloat16"):
        g = torch.Generator(device=dev).manual_seed(2024)
        t0 = time.perf_counter()
        idx = FlatIndex(D, dtype=dtype_name, device="cuda")
        idx.reserve(N)
        for base in range(0, N, 131072):
            n = min(131072, N - base)
            idx.add(torch.randn(n, D, generator=g, device=dev))
        dead = torch.randperm(N, generator=g, device=dev)[: N // 100]
        idx.delete(dead.cpu().numpy())
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        x, bias = idx.arrays()
        x, bias = x[:N], bias[:N]  # capacity padding is dead rows; time the live corpus
        elt = x.element_size()
        shapes = [("K1", 1, 30), ("K1", 1, 300), ("K1", 8, 30), ("K1", 8, 300)]
        xt = None
        if dtype_name == "float32":
            shapes += [("K2", B, k) for B in (32, 64) for k in (30, 300)]
            shapes += [(name, B, k) for name in ("K2", "K3", "K4") for B in (256, 1024)
                       for k in (30, 100, 300)]
            xt = x.T.contiguous()  # K4's corpus: the same rows as xt [D, N]
        else:
            shapes += [("K2", 256, 30), ("K2", 256, 300), ("K2", 1024, 30), ("K2", 1024, 300)]
        flat = {"K1": topk.streaming_topk_cuda, "K2": topk.streaming_topk_cuda_qmajor,
                "K3": topk.streaming_topk_cuda_qres,
                "K4": lambda q_, x_, b_, k_: topk.streaming_topk_cuda_qmajor_xt(q_, xt, b_, k_)}
        plain_cache = {}
        for name, B, k in shapes:
            fn = flat[name]
            batches = [
                _unit(torch, torch.randn(B, D, generator=g, device=dev)).to(idx.dtype)
                for _ in range(7)
            ]
            ms = _time_ms(torch, lambda qb: fn(qb, x, bias, k), batches)
            lib_ms = _time_ms(torch, lambda qb: yardstick(torch, qb, x, bias, k), batches[:3])
            if (B, k) not in plain_cache:  # K2, K3 and K4 share their plain version
                plain_cache[(B, k)] = _time_ms(
                    torch, lambda qb: topk.streaming_topk(qb, x, bias, k), batches[:2])
            plain_ms = plain_cache[(B, k)]
            # correctness on a sample of the first batch against the yardstick
            qs = batches[0][: min(B, 16)].contiguous()
            s_k, i_k = fn(qs, x, bias, k)
            s_y, i_y = yardstick(torch, qs, x, bias, k)
            err, n_diff, bad = check_topk(torch, qs, x, bias, s_k, i_k, s_y, i_y)
            errs[name] = max(errs[name], err)
            bound, bound_by = _bound(N * D * elt + N * 4 + B * D * elt + B * k * 8,
                                     2.0 * B * N * D, dtype_name)
            row = {"phase": 3, "kernel": name, "dtype": dtype_name, "N": N, "D": D,
                   "B": B, "k": k, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": bound_by,
                   "share_of_bound": bound / ms, "max_abs_err": err,
                   "id_mismatches": n_diff, "mismatches_outside_ties": bad,
                   "index_build_seconds": round(build_s, 3)}
            emit(row)
            rows_out.append(row)
            require(bad == 0, f"phase 3: {bad} mismatches outside ties ({name} {dtype_name} B={B} k={k})")
        del idx, x, xt, bias
        torch.cuda.empty_cache()
    return rows_out


def _hybrid_vs_cpu(torch, cg, cpu, hits, k, judge) -> dict:
    """The card's vector stage and hybrid top-10 against the same snapshot
    searched on the CPU. Vector stage: the prefetch (k) tie-aware. Hybrid
    stage: top-10 scores position by position, unless a tie at the
    prefetch boundary let a different chunk in (then the candidate sets
    differ legitimately and are counted)."""
    index = cg.indexer.index
    bad, diff, err, boundary_ties = 0, 0, 0.0, 0
    qe = cg.indexer.provider.embed_texts(QUERIES)
    for qt, e, got in zip(QUERIES, qe, hits):
        s_g, i_g = index.search(e[None, :], k)
        s_c, i_c = cpu.indexer.index.search(e[None, :], k)
        q1 = torch.nn.functional.normalize(torch.as_tensor(e[None, :], device="cuda"), dim=1)
        _, _, bad_v = check_topk(torch, None, None, None,
                                 *(torch.as_tensor(a, device="cuda") for a in (s_g, i_g, s_c, i_c)),
                                 judge=judge(q1))
        bad += bad_v
        ref = cpu.search(qt, limit=10)
        require(len(got) == len(ref) > 0, f"{len(got)} vs {len(ref)} hits for {qt!r}")
        require(all(math.isfinite(a.score) for a in got), "non-finite hybrid score")
        if set(i_g[0].tolist()) != set(i_c[0].tolist()):
            boundary_ties += 1
            continue
        for a, b in zip(got, ref):
            d = abs(a.score - b.score)  # position by position: a swap is a tie
            err = max(err, d)
            diff += a.node_id != b.node_id
            bad += d > SCORE_TOL
    return {"max_abs_err": err, "id_mismatches": diff, "mismatches_outside_ties": bad,
            "queries_with_prefetch_boundary_ties": boundary_ties}


def phase4(torch, mods, errs) -> dict:
    """The int8 main path: index.dtype = "int8" through the entry points."""
    from codegraph_tpu_torch.api import CodeGraph, index_memory_budget
    from codegraph_tpu_torch.core.config import CodeGraphConfig
    from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex
    from codegraph_tpu_torch.search.service import QueryService
    from codegraph_tpu_torch.utils.tuning import plan_index

    quantize = mods["quantize"]
    src = os.path.join(ROOT, "codegraph_tpu")
    require(os.path.isdir(src), f"no JAX package source at {src} to index")
    tmp = tempfile.mkdtemp(prefix="cg_smoke_int8_")
    svc = None
    try:
        proj = os.path.join(tmp, "codegraph_tpu")
        shutil.copytree(src, proj, ignore=shutil.ignore_patterns("__pycache__"))

        def config(data):
            cfg = CodeGraphConfig()
            cfg.embedding.provider = "hash"
            cfg.embedding.dimension = 768
            cfg.data_dir = os.path.join(tmp, data)
            return cfg

        cfg = config("data")
        cfg.index.dtype = "int8"
        reset_launches(mods)
        t0 = time.perf_counter()
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        stats = cg.index()
        t_index = time.perf_counter() - t0

        t0 = time.perf_counter()
        hits = [cg.search(qt, limit=10) for qt in QUERIES]
        t_search = time.perf_counter() - t0

        index = cg.indexer.index
        texts = [f"{QUERIES[i % 5]} variant {i}" for i in range(64)]
        embs = cg.indexer.provider.embed_texts(texts)
        k = 30
        t0 = time.perf_counter()
        svc = QueryService.auto(index, k=k)
        futures = [svc.submit(e) for e in embs]
        batched = [f.result(timeout=120) for f in futures]
        svc.close()
        svc_stats = svc.stats
        svc = None
        t_service = time.perf_counter() - t0
        # the main path ends here; later launches only check results
        launches = read_launches(mods)
        require(isinstance(index, Int8FlatIndex), f"phase 4 built {type(index).__name__}")
        singles = [index.search(e[None, :], k) for e in embs]

        # batched (K6) vs single (K5) final results: the rescore of the
        # bf16 rows decides, so a tie is judged by those rows' dot product
        qv_x, s_x, r_x, bias = index.arrays()
        no_bias = torch.zeros_like(bias)

        def rescore_judge(q):
            return dot_judge(q, r_x, no_bias)

        qn = torch.nn.functional.normalize(torch.as_tensor(embs, device="cuda"), dim=1)
        s_b = torch.as_tensor(np.stack([b[0] for b in batched]), device="cuda")
        i_b = torch.as_tensor(np.stack([b[1] for b in batched]), device="cuda")
        s_1 = torch.as_tensor(np.stack([s[0][0] for s in singles]), device="cuda")
        i_1 = torch.as_tensor(np.stack([s[1][0] for s in singles]), device="cuda")
        err_svc, diff_svc, bad_svc = check_topk(torch, None, None, None, s_b, i_b, s_1, i_1,
                                                judge=rescore_judge(qn))

        # each kernel against its plain version at the main path's shapes
        cand_k = min(max(k, index.rescore_k), index.capacity)
        main_shapes = {}
        for name, B in (("K5", 1), ("K6", 64)):
            qv, qs = quantize.quantize_rows(qn[:B])
            args = (qv, qs, qv_x, s_x, bias)
            s_k, i_k = wrapper(mods, name)(*args, cand_k)
            s_p, i_p = quantize.streaming_topk_int8(*args, cand_k)
            e, n_d, b_d = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                     judge=int8_judge(*args))
            b_d += int(((s_k != s_p) & (s_p > NEG_INF / 2)).sum())
            errs[name] = max(errs[name], e)
            main_shapes[name] = {"N": int(qv_x.shape[0]), "B": B, "k": cand_k, "max_abs_err": e,
                                 "id_mismatches": n_d, "mismatches_outside_ties": b_d}

        # the same snapshot searched on the CPU (plain versions) as reference
        cpu = CodeGraph(cfg, device="cpu")
        require(isinstance(cpu.indexer.index, Int8FlatIndex) and
                cpu.indexer.index.n_rows == index.n_rows, "phase 4: CPU snapshot load")
        hybrid = _hybrid_vs_cpu(torch, cg, cpu, hits, k, rescore_judge)

        # the planner: a capacity whose bf16 rows overflow this card's
        # budget and whose int8 rows fit
        budget = index_memory_budget("cuda")
        capacity = int(budget // (768 * 1.5))
        pcfg = config("planned")
        pcfg.index.capacity = capacity
        planned = CodeGraph.open(proj, config=pcfg, device="cuda")
        plan = plan_index(capacity, 768, hbm_budget_bytes=budget)
        out = {
            "phase": 4, "files": stats.files_total, "nodes": stats.nodes,
            "chunks": stats.chunks, "edges": stats.edges_total,
            "index": type(index).__name__, "index_rows": index.n_rows,
            "index_capacity": index.capacity, "rescore_dtype": str(index.rescore_dtype),
            "rescore_k": index.rescore_k,
            "index_seconds": round(t_index, 3),
            "stage_seconds": {k_: round(v, 3) for k_, v in stats.stage_seconds.items()},
            "search_seconds_5": round(t_search, 3),
            "search_perf": cg.indexer.search.monitor.report(),
            "service_seconds_64": round(t_service, 3),
            "service_batches": svc_stats.batches, "service_max_batch": svc_stats.max_batch_seen,
            "launches": launches,
            "top1": [h[0].name if h else None for h in hits],
            "service_vs_single": {"max_abs_err": err_svc, "id_mismatches": diff_svc,
                                  "mismatches_outside_ties": bad_svc},
            "hybrid_vs_cpu": hybrid,
            "kernel_vs_plain_main_shapes": main_shapes,
            "plan": {"capacity": capacity, "budget_bytes": budget, "kind": pcfg.index.kind,
                     "dtype": pcfg.index.dtype, "rescore_k": pcfg.index.rescore_k,
                     "tile_n": plan.tile_n, "reason": plan.reason,
                     "index": type(planned.indexer.index).__name__},
        }
        emit(out)
        require(stats.nodes > 0 and stats.chunks > 0 and stats.edges_total > 0, "empty index")
        require(bad_svc == 0, "phase 4: service results disagree with single queries")
        require(all(v["mismatches_outside_ties"] == 0 for v in main_shapes.values()),
                "phase 4: a kernel disagrees with its plain version at the main path's shapes")
        require(hybrid["mismatches_outside_ties"] == 0,
                "phase 4: CUDA hybrid results disagree with the CPU path")
        require(launches["K5"] > 0 and launches["K6"] > 0,
                f"phase 4: int8 main path did not launch K5 and K6: {launches}")
        require(launches["K1"] == launches["K2"] == 0,
                f"phase 4: int8 main path launched a flat kernel: {launches}")
        require(pcfg.index.dtype == "int8" and isinstance(planned.indexer.index, Int8FlatIndex),
                f"phase 4: planner chose {pcfg.index.kind}/{pcfg.index.dtype} for {capacity} rows")
        return out
    finally:
        if svc is not None:
            svc.close()
        shutil.rmtree(tmp, ignore_errors=True)


def int8_yardstick(torch, qv, qs, xv, xs, bias, k, chunk=131072):
    """Chunked torch._int_mm + scales + torch.topk (library calls; used
    only here). torch._int_mm takes more than 16 rows: a smaller batch is
    padded with zero rows, which are dropped."""
    B = qv.shape[0]
    if B < 17:
        qv = torch.cat([qv, qv.new_zeros((17 - B, qv.shape[1]))])
    ss, ii = [], []
    for base in range(0, xv.shape[0], chunk):
        raw = torch._int_mm(qv, xv[base: base + chunk].t())[:B]
        s = raw.float() * qs[:, None] * xs[base: base + chunk][None, :] + bias[base: base + chunk]
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        ss.append(v)
        ii.append(i + base)
    s = torch.cat(ss, 1)
    v, p = torch.topk(s, k, dim=1)
    return v, torch.gather(torch.cat(ii, 1), 1, p).int()


def phase5(torch, mods, errs) -> list:
    """Real size of the int8 tier: 10M x 768 with a bf16 rescore copy."""
    from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex

    quantize = mods["quantize"]
    dev = torch.device("cuda")
    N, D = 10_000_000, 768
    require(N % 8 == 0, "phase 5: torch._int_mm needs N % 8 == 0")
    g = torch.Generator(device=dev).manual_seed(2025)
    t0 = time.perf_counter()
    idx = Int8FlatIndex(D, rescore_dtype="bfloat16", device="cuda")
    idx.reserve(N)
    for base in range(0, N, 131072):
        idx.add(torch.randn(min(131072, N - base), D, generator=g, device=dev))
    dead = torch.randperm(N, generator=g, device=dev)[: N // 100]
    idx.delete(dead.cpu().numpy())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mem_gb = torch.cuda.memory_allocated() / 1e9
    xv, xs, _, bias = idx.arrays()
    xv, xs, bias = xv[:N], xs[:N], bias[:N]  # capacity padding is dead rows; time the live corpus
    rows_out = []
    plain_cache = {}  # K6 and K7 compute the same function: one plain timing per shape
    shapes = [("K5", 1, 100), ("K5", 1, 300), ("K5", 8, 100), ("K5", 8, 300)]
    shapes += [(name, B, k) for name in ("K6", "K7") for B in (64, 256, 1024) for k in (100, 300)]
    shapes += [("K6s", 1024, 100)]  # the mma.sync kernel, called directly at D=768
    for name, B, k in shapes:
        fn = wrapper(mods, name)
        batches = [quantize.quantize_rows(_unit(torch, torch.randn(B, D, generator=g, device=dev)))
                   for _ in range(7)]
        outs = []
        ms = _time_ms(torch, lambda b: fn(b[0], b[1], xv, xs, bias, k), batches, outs)
        lib_ms = _time_ms(torch, lambda b: int8_yardstick(torch, b[0], b[1], xv, xs, bias, k),
                          batches[:3])
        if (B, k) not in plain_cache:
            plain_cache[(B, k)] = _time_ms(
                torch, lambda b: quantize.streaming_topk_int8(b[0], b[1], xv, xs, bias, k),
                batches[:2])
        # correctness: a sample of every timed batch against the yardstick
        err, n_diff, bad = 0.0, 0, 0
        m = min(B, 4)
        for (qv, qs), (s_k, i_k) in zip(batches, outs):
            args = (qv[:m].contiguous(), qs[:m].contiguous(), xv, xs, bias)
            s_y, i_y = int8_yardstick(torch, *args, k)
            e, d, b_ = check_topk(torch, None, None, None, s_k[:m], i_k[:m], s_y, i_y,
                                  judge=int8_judge(*args))
            err, n_diff, bad = max(err, e), n_diff + d, bad + b_
        errs[name] = max(errs[name], err)
        bound, bound_by = _bound(N * D + 8 * N + B * D + 4 * B + B * k * 8, 2.0 * B * N * D, "int8")
        row = {"phase": 5, "kernel": name, "dtype": "int8", "N": N, "D": D, "B": B, "k": k,
               "ms": ms, "plain_ms": plain_cache[(B, k)], "library_ms": lib_ms,
               "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
               "max_abs_err": err, "sampled_rows": m * len(batches), "id_mismatches": n_diff,
               "mismatches_outside_ties": bad, "index_build_seconds": round(build_s, 3),
               "device_gb_allocated": round(mem_gb, 3)}
        emit(row)
        rows_out.append(row)
        require(bad == 0, f"phase 5: {bad} mismatches outside ties ({name} B={B} k={k})")
    # the index end to end: quantize, scan (K5 or K6), rescore, copy back
    stages = search_stages(torch, mods, idx, g, 1024, 10)
    live = torch.ones(idx.capacity, dtype=torch.bool)
    live[dead.cpu()] = False
    live[N:] = False
    for B in (1, 1024):
        batches = [torch.randn(B, D, generator=g, device=dev) for _ in range(7)]
        idx.search(batches[0], 10)  # warm
        times = []
        for qb in batches:
            t0 = time.perf_counter()
            s_np, i_np = idx.search(qb, 10)  # returns host arrays: synchronized
            times.append((time.perf_counter() - t0) * 1e3)
        ok = (s_np.shape == (B, 10) and np.isfinite(s_np).all() and (i_np >= 0).all()
              and bool(live[torch.as_tensor(i_np).long()].all()))
        row = {"phase": 5, "kind": "Int8FlatIndex.search", "N": N, "D": D, "B": B, "k": 10,
               "rescore_k": idx.rescore_k, "ms": statistics.median(times),
               "ms_all": [round(t, 3) for t in times], "results_ok": ok}
        if B == 1024:
            row["stage_ms"] = stages
        emit(row)
        rows_out.append(row)
        require(ok, f"phase 5: Int8FlatIndex.search at B={B} returned dead or missing rows")
    del idx, xv, xs, bias
    torch.cuda.empty_cache()
    return rows_out


def search_stages(torch, mods, idx, g, B, k) -> dict:
    """Median ms (CUDA events, 5 batches) of each stage of
    Int8FlatIndex.search at batch B: quantize the queries, the scan (K6 at
    B >= 32), the rescore of the candidates, and the copy of the results
    to the host."""
    quantize = mods["quantize"]
    x_q, x_s, x_r, bias = idx.arrays()
    cand_k = min(max(k, idx.rescore_k), idx.capacity)
    qs = [torch.nn.functional.normalize(torch.randn(B, idx.dim, generator=g, device="cuda"), dim=1)
          for _ in range(5)]
    qz = [quantize.quantize_rows(q) for q in qs]
    scan = wrapper(mods, "K6" if B >= 32 else "K5")
    cands = [scan(v, s, x_q, x_s, bias, cand_k) for v, s in qz]
    res = [quantize.rescore_topk(q, x_r, c[1], c[0], k) for q, c in zip(qs, cands)]
    out = {"quantize": _time_ms(torch, lambda q: quantize.quantize_rows(q), qs),
           "scan": _time_ms(torch, lambda z: scan(z[0], z[1], x_q, x_s, bias, cand_k), qz),
           "rescore": _time_ms(torch, lambda i: quantize.rescore_topk(qs[i], x_r, cands[i][1],
                                                                      cands[i][0], k),
                               list(range(5))),
           "copy_back": _time_ms(torch, lambda r: (r[0].cpu(), r[1].cpu()), res)}
    out["sum"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# the IVF tiers
# ---------------------------------------------------------------------------


def _project_copy(tmp) -> str:
    src = os.path.join(ROOT, "codegraph_tpu")
    require(os.path.isdir(src), f"no JAX package source at {src} to index")
    proj = os.path.join(tmp, "codegraph_tpu")
    shutil.copytree(src, proj, ignore=shutil.ignore_patterns("__pycache__"))
    return proj


def _hash_config(tmp, data, kind="flat"):
    from codegraph_tpu_torch.core.config import CodeGraphConfig

    cfg = CodeGraphConfig()
    cfg.embedding.provider = "hash"
    cfg.embedding.dimension = 768
    cfg.data_dir = os.path.join(tmp, data)
    cfg.index.kind = kind
    return cfg


def refine_rows(torch, index):
    """The host int8 refine bank of an IVF-PQ index as f32 rows on the card."""
    raw = torch.as_tensor(np.concatenate(index._raw_chunks), device="cuda").float()
    return raw * torch.as_tensor(np.concatenate(index._raw_scales), device="cuda")


def ivf_rows(torch, index):
    """An IVF index's stored rows by row id ([n_rows, D] f32 on the card)."""
    _, x, ids, _ = index.arrays()
    rows = torch.zeros((index.n_rows, index.dim), device="cuda")
    live = ids >= 0
    rows[ids[live].long()] = x[live].float()
    return rows


def _narrow_filter(cg, proj, max_frac=0.03):
    """A SearchFilters (one path prefix of the project) that keeps more than
    0 and at most max_frac of the index rows, and its row mask."""
    from codegraph_tpu_torch.core.types import SearchFilters

    bank, n = cg.indexer.search.filters_bank, cg.indexer.index.n_rows
    for name in sorted(os.listdir(proj)):
        filt = SearchFilters.make(path_prefixes=[os.path.join(proj, name)])
        eb = bank.bias_for(filt, n)
        frac = float((eb > NEG_INF / 2).mean()) if eb is not None else 1.0
        if 0 < frac <= max_frac:
            return filt, eb, frac
    raise CheckFailed("phase 6: no path prefix keeps <= 3% of the rows")


def _hits_vs(got, ref, tol=SCORE_TOL) -> dict:
    """Hybrid hits position by position: a swap is a tie within tol."""
    require(len(got) == len(ref) > 0, f"{len(got)} vs {len(ref)} hits")
    require(all(math.isfinite(h.score) for h in got), "non-finite hybrid score")
    err = max(abs(a.score - b.score) for a, b in zip(got, ref))
    return {"max_abs_err": err, "id_mismatches": sum(a.node_id != b.node_id for a, b in zip(got, ref)),
            "mismatches_outside_ties": int(err > tol)}


def phase6(torch, mods, errs) -> dict:
    """The IVF tiers through the entry points: IVF-PQ (K8), IVF, the planner."""
    from codegraph_tpu_torch.api import CodeGraph, index_memory_budget
    from codegraph_tpu_torch.index.ivf import IVFIndex
    from codegraph_tpu_torch.index.ivfpq import IVFPQIndex, _filter_fetch_k
    from codegraph_tpu_torch.search.service import QueryService
    from codegraph_tpu_torch.utils.tuning import plan_index

    ivfpq = mods["ivfpq"]
    tmp = tempfile.mkdtemp(prefix="cg_smoke_ivf_")
    svc = None
    try:
        proj = _project_copy(tmp)
        k = 30
        # -- IVF-PQ at the config defaults ---------------------------------
        cfg = _hash_config(tmp, "data_ivfpq", "ivfpq")
        reset_launches(mods)
        t0 = time.perf_counter()
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        stats = cg.index()
        t_index = time.perf_counter() - t0
        t0 = time.perf_counter()
        hits = [cg.search(qt, limit=10) for qt in QUERIES]
        t_search = time.perf_counter() - t0
        index = cg.indexer.index
        filt, eb, frac = _narrow_filter(cg, proj)
        fetch_k = _filter_fetch_k(k, eb, index.list_cap * index.nprobe)
        # the query is the text of a chunk inside the filter, so that the
        # probed cells hold allowed rows (its own row at least)
        store = cg.indexer.store
        f_query = next(c.text for c in store.chunks.values()
                       if store.nodes[c.parent_node].location.file_path.startswith(
                           filt.path_prefixes[0]))
        t0 = time.perf_counter()
        f_hits = cg.indexer.search.search_text(f_query, 10, filters=filt)
        t_filter = time.perf_counter() - t0
        texts = [f"{QUERIES[i % 5]} variant {i}" for i in range(64)]
        embs = cg.indexer.provider.embed_texts(texts)
        t0 = time.perf_counter()
        svc = QueryService.auto(index, k=k)
        batched = [f.result(timeout=120) for f in [svc.submit(e) for e in embs]]
        svc.close()
        svc_stats = svc.stats
        svc = None
        t_service = time.perf_counter() - t0
        # the main path ends here; later launches only check results
        launches = read_launches(mods)
        require(isinstance(index, IVFPQIndex), f"phase 6 built {type(index).__name__}")
        singles = [index.search(e[None, :], k) for e in embs]
        rows = refine_rows(torch, index)
        zeros = torch.zeros(rows.shape[0], device="cuda")
        qn = torch.nn.functional.normalize(torch.as_tensor(embs, device="cuda"), dim=1)
        s_b, i_b, s_1, i_1 = (torch.as_tensor(np.stack(a), device="cuda") for a in (
            [b[0] for b in batched], [b[1] for b in batched],
            [s[0][0] for s in singles], [s[1][0] for s in singles]))
        err_svc, diff_svc, bad_svc = check_topk(torch, None, None, None, s_b, i_b, s_1, i_1,
                                                judge=dot_judge(qn, rows, zeros))
        # K8 against its plain version at the main path's shapes
        centroids, codes, ids, bias = index.arrays()
        state = (centroids, codes, ids, bias, index._books)
        k_refine = max(k, min(k * index.refine_factor, index.list_cap * index.nprobe))
        main_shapes = {}
        for B, kk in ((1, k_refine), (64, k_refine), (1, fetch_k)):
            s_k, i_k = ivfpq.ivfpq_search_cuda(qn[:B].contiguous(), *state, kk, index.nprobe,
                                               extents=index._extents())
            s_p, i_p = ivfpq.ivfpq_search(qn[:B], *state, kk, index.nprobe)
            e, n_d, b_d = check_topk(torch, None, None, None, s_k, i_k, s_p, i_p,
                                     judge=adc_judge(torch, qn[:B], *state))
            errs["K8"] = max(errs["K8"], e)
            main_shapes[f"B={B} k={kk}"] = {"max_abs_err": e, "id_mismatches": n_d,
                                            "mismatches_outside_ties": b_d}
        # the same snapshot searched on the CPU (plain versions) as reference
        cpu = CodeGraph(cfg, device="cpu")
        require(isinstance(cpu.indexer.index, IVFPQIndex)
                and cpu.indexer.index.n_rows == index.n_rows, "phase 6: CPU snapshot load")
        hybrid = _hybrid_vs_cpu(torch, cg, cpu, hits, k, lambda q: dot_judge(q, rows, zeros))
        filtered = _hits_vs(f_hits, cpu.indexer.search.search_text(f_query, 10, filters=filt))
        kept = all(cg.indexer.store.nodes[h.node_id].location.file_path.startswith(
            filt.path_prefixes[0]) for h in f_hits)
        ivfpq_out = {
            "files": stats.files_total, "chunks": stats.chunks, "index_rows": index.n_rows,
            "stats": index.stats(), "index_seconds": round(t_index, 3),
            "stage_seconds": {k_: round(v, 3) for k_, v in stats.stage_seconds.items()},
            "search_seconds_5": round(t_search, 3),
            "search_perf": cg.indexer.search.monitor.report(),
            "filtered": {"rows_kept": frac, "fetch_k": fetch_k, "seconds": round(t_filter, 3),
                         "hits": len(f_hits), "all_in_filter": kept, "vs_cpu": filtered},
            "service_seconds_64": round(t_service, 3), "service_batches": svc_stats.batches,
            "service_max_batch": svc_stats.max_batch_seen, "launches": launches,
            "top1": [h[0].name if h else None for h in hits],
            "service_vs_single": {"max_abs_err": err_svc, "id_mismatches": diff_svc,
                                  "mismatches_outside_ties": bad_svc},
            "hybrid_vs_cpu": hybrid, "kernel_vs_plain_main_shapes": main_shapes,
        }
        # -- IVF (no kernel) -------------------------------------------------
        icfg = _hash_config(tmp, "data_ivf", "ivf")
        reset_launches(mods)
        t0 = time.perf_counter()
        cg_ivf = CodeGraph.open(proj, config=icfg, device="cuda")
        istats = cg_ivf.index()
        hits_ivf = [cg_ivf.search(qt, limit=10) for qt in QUERIES]
        t_ivf = time.perf_counter() - t0
        launches_ivf = read_launches(mods)
        iidx = cg_ivf.indexer.index
        require(type(iidx) is IVFIndex, f"phase 6 built {type(iidx).__name__} for kind ivf")
        irows = ivf_rows(torch, iidx)
        izeros = torch.zeros(irows.shape[0], device="cuda")
        hybrid_ivf = _hybrid_vs_cpu(torch, cg_ivf, CodeGraph(icfg, device="cpu"), hits_ivf, k,
                                    lambda q: dot_judge(q, irows, izeros))
        # -- the planner sends a large capacity to IVF-PQ on this card --------
        budget = index_memory_budget("cuda")
        capacity = max(60_000_000, budget // 768 + 1)  # int8 rows over the budget
        pcfg = _hash_config(tmp, "data_planned")
        pcfg.index.capacity = capacity
        t0 = time.perf_counter()
        planned = CodeGraph.open(proj, config=pcfg, device="cuda")
        plan = plan_index(capacity, 768, hbm_budget_bytes=budget)
        pstats = planned.index()
        phits = planned.search(QUERIES[0], limit=10)
        t_planned = time.perf_counter() - t0
        pidx = planned.indexer.index
        out = {
            "phase": 6, "ivfpq": ivfpq_out,
            "ivf": {"index_rows": iidx.n_rows, "stats": iidx.stats(),
                    "seconds_index_and_5_searches": round(t_ivf, 3), "launches": launches_ivf,
                    "top1": [h[0].name if h else None for h in hits_ivf],
                    "hybrid_vs_cpu": hybrid_ivf},
            "planned": {"capacity": capacity, "budget_bytes": budget, "plan": plan.to_dict(),
                        "index": type(pidx).__name__, "nlist_after_shrink": pidx.nlist,
                        "fill_entries": len(pidx._fill), "chunks": pstats.chunks,
                        "live": len(pidx), "hits": len(phits),
                        "seconds_open_index_search": round(t_planned, 3)},
        }
        emit(out)
        require(stats.chunks > 0 and len(index) == stats.chunks, "phase 6: IVF-PQ index rows")
        require(bad_svc == 0, "phase 6: service results disagree with single queries")
        require(all(v["mismatches_outside_ties"] == 0 for v in main_shapes.values()),
                "phase 6: K8 disagrees with its plain version at the main path's shapes")
        require(fetch_k > 1024, f"phase 6: the filtered fetch {fetch_k} is not above 1,024")
        require(hybrid["mismatches_outside_ties"] == 0 and filtered["mismatches_outside_ties"] == 0
                and kept, "phase 6: CUDA IVF-PQ results disagree with the CPU path")
        require(launches["K8"] > 0, f"phase 6: the IVF-PQ main path did not launch K8: {launches}")
        require(all(v == 0 for n, v in launches.items() if n != "K8"),
                f"phase 6: the IVF-PQ main path launched a flat or int8 kernel: {launches}")
        require(all(v == 0 for v in launches_ivf.values()),
                f"phase 6: the IVF path launched a kernel: {launches_ivf}")
        require(hybrid_ivf["mismatches_outside_ties"] == 0,
                "phase 6: CUDA IVF results disagree with the CPU path")
        require(pcfg.index.kind == "ivfpq" and isinstance(pidx, IVFPQIndex) and len(phits) > 0,
                f"phase 6: planner chose {pcfg.index.kind} for {capacity} rows")
        return out
    finally:
        if svc is not None:
            svc.close()
        shutil.rmtree(tmp, ignore_errors=True)


class StageTimer:
    """Seconds spent in named functions (each call synchronized), by
    wrapping them in place for the duration of a `with` block."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.seconds, self._saved = torch, targets, {}, []

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            self.seconds[name] = 0.0
            setattr(owner, attr, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def run(*args, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            return out
        return run

    def __exit__(self, *exc):
        for owner, attr, fn in self._saved:
            setattr(owner, attr, fn)


def mixture_chunk(torch, centers, base, n, seed, spread):
    """Rows [base, base + n) of the clustered mixture, made on the card from
    a generator seeded per chunk, so that any chunk can be made again."""
    g = torch.Generator(device="cuda").manual_seed(seed * 1_000_003 + base)
    pick = torch.randint(0, centers.shape[0], (n,), generator=g, device="cuda")
    return centers[pick] + spread * torch.randn(n, centers.shape[1], generator=g, device="cuda")


def phase7(torch, mods, errs) -> list:
    """Real size of the IVF-PQ tier: 10M x 768 rows, device refine bank."""
    import codegraph_tpu_torch.index.ivf as ivf_mod
    from codegraph_tpu_torch.index.ivfpq import IVFPQIndex

    ivfpq = mods["ivfpq"]
    # the reference's clustered mixture (benchmarks/bench_build_device.py
    # gen_clustered): 16,384 unit centers, offsets of expected norm 1
    N, D, CHUNK, SEED = 10_000_000, 768, 524_288, 2026
    SPREAD = 1.0 / math.sqrt(D)
    nlist, nprobe, m = 4096, 64, 96
    gc = torch.Generator(device="cuda").manual_seed(SEED)
    centers = _unit(torch, torch.randn(16_384, D, generator=gc, device="cuda"))
    torch.cuda.reset_peak_memory_stats()
    idx = IVFPQIndex(D, nlist=nlist, nprobe=nprobe, m=m, refine="int8_device", device="cuda")
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    idx.reserve(N)
    torch.cuda.synchronize()
    t_reserve = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.train(mixture_chunk(torch, centers, N, idx.train_sample, SEED + 1, SPREAD))
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    stages = {"assign": (ivf_mod, "assign_clusters_topk"), "pq_encode": (ivfpq, "pq_encode"),
              "spill": (ivf_mod.IVFIndex, "_spill"), "scatter": (IVFPQIndex, "_scatter_payload"),
              "refine_bank": (ivfpq, "_quantize_rows_device")}
    t_gen = 0.0
    with StageTimer(torch, stages) as timer:
        for base in range(0, N, CHUNK):
            t0 = time.perf_counter()
            rows = mixture_chunk(torch, centers, base, min(CHUNK, N - base), SEED, SPREAD)
            torch.cuda.synchronize()
            t_gen += time.perf_counter() - t0
            idx.add(rows)
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    dead = torch.randperm(N, generator=g, device="cuda")[: N // 100]
    t0 = time.perf_counter()
    idx.delete(dead.cpu().numpy())
    torch.cuda.synchronize()
    t_delete = time.perf_counter() - t0
    build_s = time.perf_counter() - t_all
    mem = {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "codes_gb": idx._x.numel() / 1e9,
           "ids_bias_gb": (idx._ids.numel() + idx._bias.numel()) * 4 / 1e9,
           "refine_bank_gb": (idx._dev_chunks[0].numel() + idx._dev_scales[0].numel() * 4) / 1e9}
    st = idx.stats()
    emit({"phase": 7, "build": {"N": N, "D": D, "nlist": nlist, "nprobe": nprobe, "m": m,
                                "list_cap": idx.list_cap, "seconds": round(build_s, 3),
                                "reserve": round(t_reserve, 3), "train": round(t_train, 3),
                                "generate": round(t_gen, 3), "delete": round(t_delete, 3),
                                **{k_: round(v, 3) for k_, v in timer.seconds.items()}},
          "memory": mem, "stats": st})
    centroids, codes, ids, bias = idx.arrays()
    state = (centroids, codes, ids, bias, idx._books)
    fill = torch.as_tensor(idx._fill[:nlist], device="cuda")
    ext = idx._extents()
    # the lookup floor: conflict-free lookups at 32 per SM and clock, at the
    # card's top SM clock
    sm_ghz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0]) / 1e3
    rows_out = []
    def queries(B, r=0):  # batch r of B queries from the same mixture
        return _unit(torch, mixture_chunk(torch, centers, N + (r + 1) * 1_000_003 + B, B,
                                          SEED + 3, SPREAD))

    # (1, 1920): the filtered fetch of phase 6 (its k_fetch at a 3% filter)
    for B, k in ((1, 40), (1, 300), (1, 1920), (8, 40), (8, 300), (256, 40), (256, 300),
                 (1024, 40), (1024, 300)):
        batches = [queries(B, r) for r in range(7)]
        outs, outs_cap = [], []
        ms = _time_ms(torch, lambda qb: ivfpq.ivfpq_search_cuda(qb, *state, k, nprobe, extents=ext),
                      batches, outs)
        # the same scan over every cell's whole cap (no extents): what the
        # extents save
        ms_cap = _time_ms(torch, lambda qb: ivfpq.ivfpq_search_cuda(qb, *state, k, nprobe),
                          batches, outs_cap)
        coarse_ms = _time_ms(torch, lambda qb: ivfpq.adc_inputs(qb, centroids, idx._books, nprobe),
                             batches)
        plain_ms = _time_ms(torch, lambda qb: ivfpq.ivfpq_search(qb, *state, k, nprobe),
                            batches[:1])

        def shared(qb):
            _, probe = ivf_mod.coarse_probe(qb, centroids, nprobe)
            return ivfpq.ivfpq_batch_search(qb, probe, ivf_mod.union_cells(probe, nlist, 16),
                                            codes, ids, bias, centroids, idx._books, k)
        lib_ms = _time_ms(torch, shared, batches[:1])
        err, n_diff, bad, sampled = 0.0, 0, 0, 0
        for r, (qb, (s_k, i_k)) in enumerate(zip(batches, outs)):
            qs = qb[: min(B, 4)]
            s_p, i_p = ivfpq.ivfpq_search(qs, *state, k, nprobe)
            for s_r, i_r in [(s_k, i_k)] + ([outs_cap[0]] if r == 0 else []):
                e, d, b_ = check_topk(torch, None, None, None, s_r[: len(qs)], i_r[: len(qs)],
                                      s_p, i_p, judge=adc_judge(torch, qs, *state))
                err, n_diff, bad, sampled = max(err, e), n_diff + d, bad + b_, sampled + len(qs)
        errs["K8"] = max(errs["K8"], err)
        # bound: the probed cells' occupied slots read once (codes, ids,
        # bias), the table, probes and outputs; operations: the coarse
        # product, the table and m f32 adds per probed slot and query
        probe = ivf_mod.coarse_probe(batches[0], centroids, nprobe)[1]
        slots = float(fill[probe].sum())
        union = float(fill[torch.unique(probe)].sum())
        # code bytes the kernel reads: every probed extent (rounded to 8),
        # once a query; the union's, which a read once a batch would take
        code_bytes = {"read": float(((ext.long()[probe] + 7) // 8 * 8).sum()) * m,
                      "union": union * m}
        nbytes = (union * (m + 8) + nlist * D * 4 + B * D * 4 + B * m * 256 * 4
                  + B * nprobe * 8 + B * k * 8)
        ops = 2.0 * B * nlist * D + 2.0 * B * D * 256 + slots * m
        bound, bound_by = _bound(nbytes, ops, "float32")
        row = {"phase": 7, "kernel": "K8", "dtype": "uint8 codes", "N": N, "D": D, "B": B, "k": k,
               "ms": ms, "ms_whole_cap": ms_cap, "coarse_and_table_ms": coarse_ms,
               "lookup_floor_ms": slots * m / (32 * 132 * sm_ghz * 1e9) * 1e3,
               "lookup_floor_sm_ghz": sm_ghz, "code_bytes": code_bytes, "plain_ms": plain_ms,
               "library_ms": lib_ms, "library": "ivfpq_batch_search (batch-shared decode)",
               "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
               "probed_slots": slots, "union_slots": union, "max_abs_err": err,
               "sampled_rows": sampled, "id_mismatches": n_diff, "mismatches_outside_ties": bad,
               "index_build_seconds": round(build_s, 3)}
        emit(row)
        rows_out.append(row)
        require(bad == 0, f"phase 7: {bad} mismatches outside ties (K8 B={B} k={k})")
    # the index end to end (K8 + device refine) and its recall@10 against an
    # exact f32 scan of the same (re-made) rows, tombstones excluded
    qr = queries(256)
    live = torch.ones(N, dtype=torch.bool, device="cuda")
    live[dead] = False
    best_s = torch.full((256, 10), -float("inf"), device="cuda")
    best_i = torch.zeros((256, 10), dtype=torch.long, device="cuda")
    t0 = time.perf_counter()
    for base in range(0, N, CHUNK):
        n = min(CHUNK, N - base)
        s = qr @ _unit(torch, mixture_chunk(torch, centers, base, n, SEED, SPREAD)).T
        s[:, ~live[base: base + n]] = -float("inf")
        v, i = torch.topk(torch.cat([best_s, s], 1), 10, dim=1)
        best_i = torch.gather(torch.cat([best_i, torch.arange(base, base + n, device="cuda")
                                         .expand(256, -1)], 1), 1, i)
        best_s = v
    torch.cuda.synchronize()
    t_exact = time.perf_counter() - t0
    _, got = idx.search(qr, 10)
    recall = float(np.mean([len(set(a) & set(b)) / 10.0
                            for a, b in zip(got.tolist(), best_i.cpu().tolist())]))
    for B in (1, 1024):
        batches = [queries(B, 10 + r) for r in range(7)]
        idx.search(batches[0], 10)  # warm
        times = []
        for qb in batches:
            t0 = time.perf_counter()
            s_np, i_np = idx.search(qb, 10)  # returns host arrays: synchronized
            times.append((time.perf_counter() - t0) * 1e3)
        ok = (s_np.shape == (B, 10) and np.isfinite(s_np).all() and (i_np >= 0).all()
              and bool(live[torch.as_tensor(i_np, device="cuda").long()].all()))
        row = {"phase": 7, "kind": "IVFPQIndex.search", "N": N, "D": D, "B": B, "k": 10,
               "refine": idx.refine, "k_fetch": 10 * idx.refine_factor,
               "ms": statistics.median(times), "ms_all": [round(t, 3) for t in times],
               "results_ok": ok}
        if B == 1024:
            row.update({"recall_at_10": recall, "recall_queries": 256,
                        "exact_scan_seconds": round(t_exact, 3)})
        emit(row)
        rows_out.append(row)
        require(ok, f"phase 7: IVFPQIndex.search at B={B} returned dead or missing rows")
    # a sanity floor: an index that lost or scrambled its rows scores ~0
    require(recall > 0.1, f"phase 7: recall@10 {recall} against the exact scan")
    del idx, state, centroids, codes, ids, bias
    torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------
# the default configuration: the ensemble provider (r3 encoder) on the card
# ---------------------------------------------------------------------------

#: the JAX package's encoder embeddings of 32 fixed texts (tools/encoder_golden.py)
GOLDEN = os.path.join(ROOT, "tests", "data", "encoder_r3_golden.npz")
ENCODER_CKPT = "encoder_r3_512.npz"
# the encoder's bf16 tolerance against the JAX package and between two
# devices (tests/test_torch_encoder.py BF16_TOL at the shipped width); the
# hybrid scores and tool results of two devices' query vectors get the same
ENC_TOL = 2e-3
ENCODER_ROUTE = ("torch.mm/torch.bmm of bf16 operands with out_dtype=torch.float32 "
                 "(tensor cores, f32 sums), f32 bias/GELU/norms/softmax")


def _tool_close(got, ref, tol) -> dict:
    """Two semantic_code_search outputs: counts equal, scores position by
    position within tol (a swap of two nodes is a tie within tol)."""
    require("error" not in got and "error" not in ref, f"tool error: {got} / {ref}")
    require(got["count"] == ref["count"] > 0, f"{got['count']} vs {ref['count']} tool results")
    err = max(abs(a["score"] - b["score"]) for a, b in zip(got["results"], ref["results"]))
    return {"count": got["count"], "max_abs_err": err,
            "id_mismatches": sum(a["node_id"] != b["node_id"]
                                 for a, b in zip(got["results"], ref["results"])),
            "mismatches_outside_ties": int(err > tol)}


def _encoder_forward_ms(torch, enc, B, L, reps=20):
    """Median ms of one encoder forward at [B, L] (CUDA events) on seeded
    random token ids, every position live."""
    from codegraph_tpu_torch.models.encoder import encode

    g = torch.Generator(device="cuda").manual_seed(8)
    ids = torch.randint(0, enc.cfg.vocab_size, (B, L), generator=g, device="cuda")
    mask = torch.ones((B, L), dtype=torch.bool, device="cuda")
    return _time_ms(torch, lambda _: encode(enc.params, ids, mask, enc.cfg), [None] * reps)


def phase8(torch, mods, errs) -> dict:
    """The default configuration through the entry points: CodeGraphConfig()
    with only data_dir set, so the ensemble provider (the r3 encoder on the
    card + the hash half), a flat f32 index, hybrid search (K1), QueryService
    (K2), the feature reranker and the semantic_code_search tool."""
    from codegraph_tpu_torch.api import CodeGraph
    from codegraph_tpu_torch.core.config import CodeGraphConfig
    from codegraph_tpu_torch.index.flat import FlatIndex
    from codegraph_tpu_torch.mcp.tools import GraphToolExecutor
    from codegraph_tpu_torch.models.bpe import BPETokenizer
    from codegraph_tpu_torch.models.providers import EncoderProvider, HybridEmbeddingPipeline
    from codegraph_tpu_torch.search.reranker import make_reranker_pipeline
    from codegraph_tpu_torch.search.service import QueryService

    require(os.path.exists(GOLDEN), f"no golden embeddings at {GOLDEN}")
    tmp = tempfile.mkdtemp(prefix="cg_smoke_default_")
    svc = None
    try:
        proj = _project_copy(tmp)
        cfg = CodeGraphConfig()
        cfg.data_dir = os.path.join(tmp, "data")

        reset_launches(mods)
        t0 = time.perf_counter()
        cg = CodeGraph.open(proj, config=cfg, device="cuda")
        t_open = time.perf_counter() - t0
        prov = cg.indexer.provider
        require(isinstance(prov, HybridEmbeddingPipeline)
                and [p.name for p in prov.providers] == ["ensemble", "hash"],
                f"phase 8: the default provider is {getattr(prov, 'name', prov)!r}")
        ens, hsh = prov.providers
        enc = ens.encoder
        require(os.path.basename(enc.checkpoint or "") == ENCODER_CKPT,
                f"phase 8: the encoder came from {enc.checkpoint!r}")
        require(isinstance(enc.tokenizer, BPETokenizer) and enc.tokenizer.vocab_size == 16644,
                f"phase 8: the encoder's tokenizer is {type(enc.tokenizer).__name__}")
        require({v.device.type for v in enc.params.values()} == {"cuda"},
                "phase 8: encoder parameters are not all on the card")
        require(isinstance(cg.indexer.index, FlatIndex) and cg.indexer.index.dim == 768,
                "phase 8: the default index is not a flat 768-d index")

        t0 = time.perf_counter()
        stats = cg.index()
        t_index = time.perf_counter() - t0
        counters = enc.counters.to_dict()
        index_texts = enc.metrics.texts

        hits, search_s = [], []
        for qt in QUERIES:
            t0 = time.perf_counter()
            hits.append(cg.search(qt, limit=10))
            search_s.append(time.perf_counter() - t0)
        # the encoder's share of a B=1 search: the same queries' embedding alone
        embed_s = []
        for qt in QUERIES:
            t0 = time.perf_counter()
            prov.embed_texts([f"{qt} again"])
            embed_s.append(time.perf_counter() - t0)
        index = cg.indexer.index
        texts = [f"{QUERIES[i % 5]} variant {i}" for i in range(64)]
        embs = prov.embed_texts(texts)
        k = 30
        t0 = time.perf_counter()
        svc = QueryService.auto(index, k=k)
        futures = [svc.submit(e) for e in embs]
        batched = [f.result(timeout=120) for f in futures]
        svc.close()
        svc_stats = svc.stats
        svc = None
        t_service = time.perf_counter() - t0
        # the main path ends here; later launches only check results
        launches = read_launches(mods)

        # the service (K2) against single queries (K1), and each kernel
        # against its plain version, on the encoder's embeddings
        singles = [index.search(e[None, :], k) for e in embs]
        x, bias = index.arrays()
        qn = torch.nn.functional.normalize(torch.as_tensor(embs, device="cuda"), dim=1)
        s_b = torch.as_tensor(np.stack([b[0] for b in batched]), device="cuda")
        i_b = torch.as_tensor(np.stack([b[1] for b in batched]), device="cuda")
        s_1 = torch.as_tensor(np.stack([s[0][0] for s in singles]), device="cuda")
        i_1 = torch.as_tensor(np.stack([s[1][0] for s in singles]), device="cuda")
        err_svc, diff_svc, bad_svc = check_topk(torch, qn, x, bias, s_b, i_b, s_1, i_1)
        errs["K2"] = max(errs["K2"], err_svc)
        topk = mods["topk"]
        main_shapes = {}
        for name, fn, B in (("K1", topk.streaming_topk_cuda, 1),
                            ("K2", topk.streaming_topk_cuda_qmajor, 64)):
            s_k, i_k = fn(qn[:B].contiguous(), x, bias, k)
            s_p, i_p = topk.streaming_topk(qn[:B], x, bias, k)
            e, n_d, b_d = check_topk(torch, qn[:B], x, bias, s_k, i_k, s_p, i_p)
            errs[name] = max(errs[name], e)
            main_shapes[name] = {"N": int(x.shape[0]), "B": B, "k": k, "max_abs_err": e,
                                 "id_mismatches": n_d, "mismatches_outside_ties": b_d}

        # the encoder against the JAX package's golden embeddings and
        # against this port's CPU path on the same texts
        gold = np.load(GOLDEN)
        gtexts = [str(t) for t in gold["texts"]]
        card_enc = enc.embed_texts(gtexts)
        card_ens = ens.embed_texts(gtexts)
        cpu_enc = EncoderProvider(batch_size=32, checkpoint=enc.checkpoint, device="cpu")
        cpu_vecs = cpu_enc.embed_texts(gtexts)
        encoder_errs = {
            "vs_jax_golden": float(np.abs(card_enc - gold["encoder"]).max()),
            "ensemble_vs_jax_golden": float(np.abs(card_ens - gold["ensemble"]).max()),
            "vs_cpu_path": float(np.abs(card_enc - cpu_vecs).max()),
            "cpu_path_vs_jax_golden": float(np.abs(cpu_vecs - gold["encoder"]).max()),
            "texts": len(gtexts),
        }
        forward_ms = {"B=1 L=64": _encoder_forward_ms(torch, enc, 1, 64),
                      "B=256 L=192": _encoder_forward_ms(torch, enc, 256, 192)}

        # the same snapshot on the CPU: the card's query vectors on both
        # sides (the index stage alone differs), then each side's own text path
        t0 = time.perf_counter()
        cpu = CodeGraph(cfg, device="cpu")
        require(len(cpu.indexer.index) == len(index), "phase 8: CPU snapshot load")
        qvecs = prov.embed_texts(QUERIES)
        same_vec, own_text = [], []
        boundary_ties = 0
        for qt, qv, got in zip(QUERIES, qvecs, hits):
            s_g, i_g = index.search(qv[None, :], 30)
            s_c, i_c = cpu.indexer.index.search(qv[None, :], 30)
            if set(i_g[0].tolist()) != set(i_c[0].tolist()):
                boundary_ties += 1  # a tie at the prefetch boundary let another chunk in
            else:
                same_vec.append(_hits_vs(cg.indexer.search.search_embedding(qv, 10, text_query=qt),
                                         cpu.indexer.search.search_embedding(qv, 10, text_query=qt)))
            own_text.append(_hits_vs(got, cpu.search(qt, limit=10), ENC_TOL))
        tool_args = {"query": QUERIES[2], "limit": 10}
        tools = GraphToolExecutor(cg.graph, cg.indexer.search,
                                  make_reranker_pipeline(prov, cfg.search),
                                  rerank_default=cfg.search.rerank)
        cpu_tools = GraphToolExecutor(cpu.graph, cpu.indexer.search,
                                      make_reranker_pipeline(cpu.indexer.provider, cfg.search),
                                      rerank_default=cfg.search.rerank)
        t1 = time.perf_counter()
        tool_out = tools.execute("semantic_code_search", tool_args)
        t_tool = time.perf_counter() - t1
        tool = _tool_close(tool_out, cpu_tools.execute("semantic_code_search", tool_args), ENC_TOL)
        tool["seconds"] = round(t_tool, 4)
        t_cpu = time.perf_counter() - t0

        def worst(rows, key):
            return max((r[key] for r in rows), default=0)

        out = {
            "phase": 8, "gpu": nvidia_smi_line(), "files": stats.files_total,
            "nodes": stats.nodes, "chunks": stats.chunks, "edges": stats.edges_total,
            "edges_semantic": stats.edges_resolved_semantic,
            "open_seconds": round(t_open, 3), "index_seconds": round(t_index, 3),
            "stage_seconds": {k_: round(v, 3) for k_, v in stats.stage_seconds.items()},
            "encoder": {**counters, "index_texts": index_texts,
                        "texts_per_s": counters["texts"] / max(
                            counters["tokenize_seconds"] + counters["forward_seconds"], 1e-9),
                        "tokens_per_s_forward": counters["tokens"] / max(
                            counters["forward_seconds"], 1e-9),
                        "route": ENCODER_ROUTE},
            "providers": {p.name: {"texts": p.metrics.texts, "failures": p.metrics.failures}
                          for p in (ens, enc, hsh)},
            "search_seconds_5": round(sum(search_s), 3),
            "search_ms_each": [round(t * 1e3, 3) for t in search_s],
            "query_embed_ms_each": [round(t * 1e3, 3) for t in embed_s],
            "search_perf": cg.indexer.search.monitor.report(),
            "service_seconds_64": round(t_service, 3),
            "service_batches": svc_stats.batches, "service_max_batch": svc_stats.max_batch_seen,
            "launches": launches,
            "service_vs_single": {"max_abs_err": err_svc, "id_mismatches": diff_svc,
                                  "mismatches_outside_ties": bad_svc},
            "kernel_vs_plain_main_shapes": main_shapes,
            "encoder_max_abs_err": encoder_errs, "encoder_forward_ms": forward_ms,
            "hybrid_same_vectors_vs_cpu": {
                "max_abs_err": worst(same_vec, "max_abs_err"),
                "id_mismatches": sum(r["id_mismatches"] for r in same_vec),
                "mismatches_outside_ties": sum(r["mismatches_outside_ties"] for r in same_vec),
                "queries_with_prefetch_boundary_ties": boundary_ties},
            "hybrid_own_text_vs_cpu": {
                "max_abs_err": worst(own_text, "max_abs_err"),
                "id_mismatches": sum(r["id_mismatches"] for r in own_text),
                "mismatches_outside_ties": sum(r["mismatches_outside_ties"] for r in own_text)},
            "tool_vs_cpu": tool, "cpu_side_seconds": round(t_cpu, 3),
            "top1": [h[0].name if h else None for h in hits],
        }
        emit(out)
        require(stats.nodes > 0 and stats.chunks > 0 and stats.edges_total > 0, "empty index")
        require(hsh.metrics.texts == 0, f"phase 8: the hash member embedded {hsh.metrics.texts} texts")
        require(all(p.metrics.failures == 0 for p in (ens, enc, hsh)),
                "phase 8: a provider recorded a failure")
        require(index_texts >= stats.chunks and len(index) == stats.chunks,
                f"phase 8: the encoder embedded {index_texts} texts for {stats.chunks} chunks")
        require(bad_svc == 0, "phase 8: service results disagree with single queries")
        require(all(v["mismatches_outside_ties"] == 0 for v in main_shapes.values()),
                "phase 8: a kernel disagrees with its plain version at the main path's shapes")
        require(launches["K1"] > 0 and launches["K2"] > 0,
                f"phase 8: the default path did not launch K1 and K2: {launches}")
        require(all(launches[n] == 0 for n in launches if n not in ("K1", "K2")),
                f"phase 8: the default path launched another kernel: {launches}")
        require(all(v <= ENC_TOL for k_, v in encoder_errs.items() if k_ != "texts"),
                f"phase 8: the encoder is off its references: {encoder_errs}")
        require(out["hybrid_same_vectors_vs_cpu"]["mismatches_outside_ties"] == 0
                and out["hybrid_own_text_vs_cpu"]["mismatches_outside_ties"] == 0,
                "phase 8: CUDA hybrid results disagree with the CPU snapshot")
        require(tool["mismatches_outside_ties"] == 0,
                "phase 8: the semantic_code_search tool disagrees with the CPU snapshot")
        return out
    finally:
        if svc is not None:
            svc.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------


def _on_alarm(signum, frame):
    raise TimeoutError(f"chip_smoke watchdog: {WATCHDOG_S}s exceeded")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7,8",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",") if p.strip()}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "codegraph_tpu_torch")):
        print(f"chip_smoke: no codegraph_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in true f32
    torch.backends.cudnn.allow_tf32 = False

    signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(WATCHDOG_S)
    faulthandler.dump_traceback_later(WATCHDOG_S + 60, exit=True)
    t_all = time.perf_counter()
    from codegraph_tpu_torch.index import ivf, ivfpq
    from codegraph_tpu_torch.ops import quantize, topk

    mods = {"topk": topk, "quantize": quantize, "ivfpq": ivfpq, "ivf": ivf}
    errs = {name: 0.0 for name in KERNELS}
    seconds = {}

    def run(n, fn, *args, empty=None):
        if n not in phases:
            return empty
        t0 = time.perf_counter()
        out = fn(torch, *args)
        seconds[n] = round(time.perf_counter() - t0, 3)
        emit({"phase": n, "seconds": seconds[n]})
        return out

    try:
        p0 = run(0, phase0)
        run(1, phase1, mods, errs)
        p2 = run(2, phase2, mods, errs)
        p3 = run(3, phase3, topk, errs, empty=[])
        p4 = run(4, phase4, mods, errs)
        p5 = run(5, phase5, mods, errs, empty=[])
        p6 = run(6, phase6, mods, errs)
        p7 = run(7, phase7, mods, errs, empty=[])
        p8 = run(8, phase8, mods, errs)
    except (CheckFailed, TimeoutError) as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()

    # each kernel at one shape of its real-size phase; launches from its
    # tier's main path, for K1 and K2 the default configuration's (phase 8)
    # when it ran (K3, K4 and K7 are public ops that no index calls; K6s
    # runs only at a D that is not a multiple of 16)
    shapes = {"K1": (p3, "float32", 1, 30), "K2": (p3, "float32", 1024, 30),
              "K3": (p3, "float32", 1024, 100), "K4": (p3, "float32", 1024, 30),
              "K5": (p5, "int8", 1, 100), "K6": (p5, "int8", 1024, 100),
              "K7": (p5, "int8", 1024, 100), "K6s": (p5, "int8", 1024, 100),
              "K8": (p7, "uint8 codes", 1, 40)}
    flat_path = p8 or p2
    paths = {"K1": flat_path, "K2": flat_path, "K3": flat_path, "K4": flat_path, "K5": p4,
             "K6": p4, "K7": p4, "K6s": p4, "K8": p6["ivfpq"] if p6 else None}
    kernels = []
    for name, (_, fn_name, source, replaces) in KERNELS.items():
        rows, dtype, B, k = shapes[name]
        row = next((r for r in rows if r.get("kernel") == name and r["dtype"] == dtype
                    and r["B"] == B and r["k"] == k), {})
        path = paths[name]
        kernels.append({
            "name": f"{name} {fn_name}", "route": "cuda", "source": source, "replaces": replaces,
            "launches": path["launches"][name] if path else None,
            "launches_by_phase": {str(n): p["launches"][name] for n, p in
                                  ((2, p2), (4, p4), (6, p6["ivfpq"] if p6 else None), (8, p8))
                                  if p},
            "max_abs_err": errs[name],
            "ms": row.get("ms"), "plain_ms": row.get("plain_ms"),
            "bound_ms": row.get("bound_ms"), "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms"),
            "shape": f"N={row['N']} D=768 {dtype} B={B} k={k}" if row else None,
        })
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_all, 3),
          "phase_seconds": seconds, "build_seconds": p0["build_seconds"] if p0 else None})
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

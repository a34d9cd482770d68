#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`codegraph_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                # all phases, one card
    python3 chip_smoke.py --phases 0,1   # build + kernel checks only

Phases, each printing one JSON object per line as it ends:

  0  card name and power limit, torch and nvcc versions; builds the CUDA
     kernels from csrc/ and prints the build seconds and ptxas lines.
  1  K1 and K2 against their plain PyTorch version on the card: f32 and
     bf16 corpora up to 131,072 x 768, k in {1, 10, 30, 100, 300}, a ragged
     N, 1% tombstones, an extra_bias filter, k above the live count and
     duplicate rows (exact ties). Fails on any id mismatch outside ties.
  2  the main path: CodeGraph.open(<copy of codegraph_tpu/>, device="cuda")
     with the hash provider at D=768, .index(), .search() for 5 queries
     (checked against the same snapshot searched on the CPU), then 64
     concurrent queries through QueryService (checked against single
     queries). Prints the counts and the kernels' launch counters, which
     must both be above zero.
  3  real size: FlatIndex of 1,000,000 x 768 rows, f32 then bf16, made on
     the card from a seeded generator, 1% tombstoned; K1 at B=1 and 8, K2
     at B=256 and 1024, k=30 and 300: median kernel ms over 7 batches
     (CUDA events), the plain version's ms, a chunked matmul + topk
     yardstick (library_ms, checked against), and the bound.

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
# bytes over the memory rate and its flops over the peak rate of its type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# Scores of unit-norm rows and queries lie in [-1, 1]. f32 sums taken in
# another order differ by ~1e-7 at D=768; bf16 rows and queries multiply
# exactly in f32, so both dtypes are held to the same bound.
SCORE_TOL = 1e-5


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


def check_topk(torch, q, x, bias, s_k, i_k, s_ref, i_ref, tol=SCORE_TOL):
    """Hold (s_k, i_k) to the reference (s_ref, i_ref), tie-aware.

    Sentinel (NEG_INF) positions must agree; live scores must agree within
    tol; live ids must be distinct per row; and where an id differs from
    the reference's, the row it names must score (recomputed in f64)
    within tol of the reference score at that position, i.e. it is tied.
    Returns (max_abs_err, id_mismatches, mismatches_outside_ties)."""
    live_k = s_k > NEG_INF / 2
    live_r = s_ref > NEG_INF / 2
    bad = int((live_k != live_r).sum())
    bad += int(((~live_k) & (i_k != -1)).sum())
    both = live_k & live_r
    err = float((s_k - s_ref).abs()[both].max()) if bool(both.any()) else 0.0
    differ = (i_k != i_ref) & both
    n_differ = int(differ.sum())
    for b in range(q.shape[0]):
        ids = i_k[b][live_k[b]]
        if ids.numel() and torch.unique(ids).numel() != ids.numel():
            bad += 1
        if bool(differ[b].any()):
            pos = differ[b].nonzero().flatten()
            rows = i_k[b][pos].long()
            true = (x[rows].double() @ q[b].double()) + bias[rows].double()
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
    cuda_build.build_all(["flat_topk"])
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_build.build_log("flat_topk").splitlines()
             if "registers" in ln or "spill" in ln]
    out = {"phase": 0, "gpu": smi, "torch": torch.__version__,
           "torch_cuda": torch.version.cuda, "nvcc": ver,
           "build_seconds": round(build_s, 3), "ptxas": ptxas}
    emit(out)
    return out


def _unit(torch, t):
    return t / t.float().norm(dim=1, keepdim=True).clamp(min=1e-6).to(t.dtype)


def phase1(torch, topk, errs) -> dict:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    D = 768
    cases = []
    # (name, N, B list K1 / K2, ks, options)
    for dtype in (torch.float32, torch.bfloat16):
        for N, dup, filt, live in ((131072, False, False, None),
                                   (100003, True, True, None),
                                   (200, False, False, 150)):
            x = _unit(torch, torch.randn(N, D, generator=g, device=dev)).to(dtype)
            if dup:  # exact ties: rows 1000..1999 repeat rows 0..999
                x[1000:2000] = x[0:1000]
            bias = torch.zeros(N, device=dev)
            dead = torch.randperm(N, generator=g, device=dev)[: max(1, N // 100)]
            bias[dead] = NEG_INF
            if live is not None:
                bias[live:] = NEG_INF
            if filt:  # extra_bias: a filter excluding ~10% of rows
                flt = torch.rand(N, generator=g, device=dev) < 0.1
                bias = bias + torch.where(flt, NEG_INF, 0.0)
            for kernel, B in (("K1", 1), ("K1", 5), ("K2", 96), ("K2", 256)):
                q = _unit(torch, torch.randn(B, D, generator=g, device=dev)).to(dtype)
                if dup:
                    q[0] = x[5]  # its own duplicate pair tops the list
                for k in (1, 10, 30, 100, 300):
                    fn = (topk.streaming_topk_cuda if kernel == "K1"
                          else topk.streaming_topk_cuda_qmajor)
                    s_k, i_k = fn(q, x, bias, k)
                    torch.cuda.synchronize()
                    s_p, i_p = topk.streaming_topk(q, x, bias, k)
                    err, n_diff, bad = check_topk(torch, q, x, bias, s_k, i_k, s_p, i_p)
                    errs[kernel] = max(errs[kernel], err)
                    cases.append({
                        "kernel": kernel, "dtype": str(dtype)[6:], "N": N, "B": B,
                        "k": k, "dup": dup, "filter": filt, "live": live or N,
                        "max_abs_err": err, "id_mismatches": n_diff,
                        "mismatches_outside_ties": bad})
    n_bad = sum(c["mismatches_outside_ties"] for c in cases)
    out = {"phase": 1, "cases": len(cases),
           "max_abs_err": {k: v for k, v in errs.items()},
           "id_mismatches": sum(c["id_mismatches"] for c in cases),
           "mismatches_outside_ties": n_bad,
           "failed": [c for c in cases if c["mismatches_outside_ties"]][:10]}
    emit(out)
    require(n_bad == 0, f"phase 1: {n_bad} mismatches outside ties")
    return out


QUERIES = [
    "parse a source file into nodes and edges",
    "streaming top-k kernel over the corpus",
    "hybrid search with bm25 and graph boost",
    "save the index snapshot manifest",
    "resolve call edges between symbols",
]


def phase2(torch, topk, errs) -> dict:
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

        topk.streaming_topk_cuda.launches = 0
        topk.streaming_topk_cuda_qmajor.launches = 0
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
        launches = {"K1": topk.streaming_topk_cuda.launches,
                    "K2": topk.streaming_topk_cuda_qmajor.launches}
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
        # Vector stage: the prefetch (k=30) on the card vs on the CPU,
        # tie-aware. Hybrid stage: top-10 scores position by position,
        # unless a tie at the prefetch boundary let a different chunk in
        # (then the candidate sets differ legitimately and are counted).
        bad_hybrid, diff_hybrid, err_hybrid, boundary_ties = 0, 0, 0.0, 0
        qe = cg.indexer.provider.embed_texts(QUERIES)
        for qt, e, got in zip(QUERIES, qe, hits):
            s_g, i_g = index.search(e[None, :], k)
            s_c, i_c = cpu.indexer.index.search(e[None, :], k)
            q1 = torch.nn.functional.normalize(torch.as_tensor(e[None, :], device="cuda"), dim=1)
            _, _, bad_v = check_topk(torch, q1, x, bias, *(torch.as_tensor(a, device="cuda")
                                                           for a in (s_g, i_g, s_c, i_c)))
            bad_hybrid += bad_v
            ref = cpu.search(qt, limit=10)
            require(len(got) == len(ref) > 0, f"phase 2: {len(got)} vs {len(ref)} hits for {qt!r}")
            require(all(math.isfinite(a.score) for a in got), "phase 2: non-finite score")
            if set(i_g[0].tolist()) != set(i_c[0].tolist()):
                boundary_ties += 1
                continue
            for a, b in zip(got, ref):
                d = abs(a.score - b.score)  # position by position: a swap is a tie
                err_hybrid = max(err_hybrid, d)
                diff_hybrid += a.node_id != b.node_id
                bad_hybrid += d > SCORE_TOL
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
            "hybrid_vs_cpu": {"max_abs_err": err_hybrid, "id_mismatches": diff_hybrid,
                              "mismatches_outside_ties": bad_hybrid,
                              "queries_with_prefetch_boundary_ties": boundary_ties},
            "kernel_vs_plain_main_shapes": main_shapes,
        }
        emit(out)
        require(stats.nodes > 0 and stats.chunks > 0 and stats.edges_total > 0, "empty index")
        require(bad_svc == 0, "phase 2: service results disagree with single queries")
        require(all(v["mismatches_outside_ties"] == 0 for v in main_shapes.values()),
                "phase 2: a kernel disagrees with its plain version at the main path's shapes")
        require(bad_hybrid == 0, "phase 2: CUDA hybrid results disagree with the CPU path")
        require(launches["K1"] > 0 and launches["K2"] > 0,
                f"phase 2: main path did not launch both kernels: {launches}")
        return out
    finally:
        if svc is not None:
            svc.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _time_ms(torch, fn, batches):
    """Median ms of fn(batch) over batches (one launch each, CUDA events)."""
    fn(batches[0])  # warm
    times = []
    for qb in batches:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(qb)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
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
        for B, k in ((1, 30), (1, 300), (8, 30), (8, 300),
                     (256, 30), (256, 300), (1024, 30), (1024, 300)):
            name = "K1" if B < 32 else "K2"
            fn = topk.streaming_topk_cuda if B < 32 else topk.streaming_topk_cuda_qmajor
            batches = [
                _unit(torch, torch.randn(B, D, generator=g, device=dev)).to(idx.dtype)
                for _ in range(7)
            ]
            ms = _time_ms(torch, lambda qb: fn(qb, x, bias, k), batches)
            lib_ms = _time_ms(torch, lambda qb: yardstick(torch, qb, x, bias, k), batches[:3])
            plain_ms = _time_ms(torch, lambda qb: topk.streaming_topk(qb, x, bias, k),
                                batches[:2])
            # correctness on a sample of the first batch against the yardstick
            qs = batches[0][: min(B, 16)].contiguous()
            s_k, i_k = fn(qs, x, bias, k)
            s_y, i_y = yardstick(torch, qs, x, bias, k)
            err, n_diff, bad = check_topk(torch, qs, x, bias, s_k, i_k, s_y, i_y)
            errs[name] = max(errs[name], err)
            nbytes = N * D * elt + N * 4 + B * D * elt + B * k * 8
            flops = 2.0 * B * N * D
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
            bound = max(t_bytes, t_ops)
            row = {"phase": 3, "kernel": name, "dtype": dtype_name, "N": N, "D": D,
                   "B": B, "k": k, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": bound, "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "share_of_bound": bound / ms, "max_abs_err": err,
                   "id_mismatches": n_diff, "mismatches_outside_ties": bad,
                   "index_build_seconds": round(build_s, 3)}
            emit(row)
            rows_out.append(row)
            require(bad == 0, f"phase 3: {bad} mismatches outside ties ({name} {dtype_name} B={B} k={k})")
        del idx, x, bias
        torch.cuda.empty_cache()
    return rows_out


# ---------------------------------------------------------------------------


def _on_alarm(signum, frame):
    raise TimeoutError(f"chip_smoke watchdog: {WATCHDOG_S}s exceeded")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="0,1,2,3",
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
    from codegraph_tpu_torch.ops import topk

    errs = {"K1": 0.0, "K2": 0.0}
    try:
        p0 = phase0(torch) if 0 in phases else None
        if 1 in phases:
            phase1(torch, topk, errs)
        p2 = phase2(torch, topk, errs) if 2 in phases else None
        p3 = phase3(torch, topk, errs) if 3 in phases else []
    except (CheckFailed, TimeoutError) as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    finally:
        signal.alarm(0)
        faulthandler.cancel_dump_traceback_later()

    kernels = []
    ref = {"K1": ("streaming_topk_cuda", 1, "codegraph_tpu/ops/topk.py:347"),
           "K2": ("streaming_topk_cuda_qmajor", 1024, "codegraph_tpu/ops/topk.py:456")}
    for name, (fn_name, B, replaces) in ref.items():
        row = next((r for r in p3 if r["kernel"] == name and r["dtype"] == "float32"
                    and r["B"] == B and r["k"] == 30), {})
        kernels.append({
            "name": f"{name} {fn_name}", "route": "cuda",
            "source": "codegraph_tpu_torch/csrc/flat_topk.cu", "replaces": replaces,
            "launches": p2["launches"][name] if p2 else None,
            "max_abs_err": errs[name],
            "ms": row.get("ms"), "plain_ms": row.get("plain_ms"),
            "bound_ms": row.get("bound_ms"), "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms"),
            "shape": f"N=1000000 D=768 f32 B={B} k=30",
        })
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_all, 3),
          "build_seconds": p0["build_seconds"] if p0 else None})
    print(nvidia_smi_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time one kernel of this checkout against the same kernel of another
checkout of the repo (for example the parent commit unpacked with `git
archive`), in turns, on one NVIDIA GPU.

    python3 tools/kernel_vs_checkout.py OTHER_DIR [--kernel K2|K2tc|K6|K8]
                                        [--rows N] [--shapes B:k,B:k,...]

K2 (`streaming_topk_cuda_qmajor`, csrc/flat_topk.cu) runs on a 1%
tombstoned f32 corpus of unit rows at D=768, 1,000,000 rows by default;
K2tc (the same wrapper over the same rows and queries rounded to bf16: the
tensor cores, csrc/flat_topk_tc.cu) likewise;
K6 (`streaming_topk_int8_cuda_qmajor`, csrc/int8_topk.cu) on the same
rows quantized to int8, 10,000,000 by default; K8 (`ivfpq_search_cuda`,
csrc/ivfpq_adc.cu) on synthetic IVF-PQ cells at chip_smoke.py's phase-7
shape (chip_smoke.synthetic_ivfpq_cells: nlist 4096, m 96, cap 4992,
~10M rows, 1% tombstoned; --rows is ignored), nprobe 64, with
the cells' fills as extents where the checkout's wrapper takes them, and
its first batch's scores saved so that the turns are compared bit for bit
(ids may differ only where scores tie); then the same cells loaded into an
IVFPQIndex (refine "none") and its search timed end to end at B=1 and 1024,
k=10 (median of 7 calls, host clock; the call returns host arrays). Each
turn is a process of
its own that imports `codegraph_tpu_torch` from one checkout (which
builds its kernels there at first use), makes the corpus on the card
from a seed, and times every B:k shape: the median ms over 7 batches
(CUDA events), after checking the first batch (K6: its first 4 rows)
against a chunked matmul + topk. The turns run other, this, this, other.
Prints the card, then one JSON line per shape with both checkouts'
times; exits 1 if a turn failed or disagreed.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


DEFAULTS = {"K2": (1_000_000, "32:30,64:30,64:300,1024:30"),
            "K2tc": (1_000_000, "64:30,64:300,256:30,256:100,256:300,1024:30,1024:300"),
            "K6": (10_000_000, "64:100,64:300,256:100,256:300,1024:100,1024:300"),
            "K8": (10_000_000, "1:40,1:300,8:40,8:300,256:40,256:300,1024:40,1024:300")}


def worker_k8(root: str, shapes, save: str) -> dict:
    """One K8 turn: the checkout at `root` on synthetic cells; the first
    batch's results of each shape go to `save` (a .pt file)."""
    import inspect

    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    sys.path.remove(ROOT)
    sys.path.insert(0, os.path.abspath(root))
    from codegraph_tpu_torch.index import ivfpq

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(2026)
    *state, fill = cs.synthetic_ivfpq_cells(torch, g)
    kw = {"extents": fill} if "extents" in inspect.signature(ivfpq.ivfpq_search_cuda).parameters \
        else {}
    out = {"root": root, "module": ivfpq.__file__, "extents": bool(kw), "ms": {},
           "mismatches_outside_ties": 0}
    first = {}
    for B, k in shapes:
        gq = torch.Generator(device="cuda").manual_seed(B * 100_003 + k)
        qs = [cs._unit(torch, torch.randn(B, 768, generator=gq, device="cuda")) for _ in range(7)]
        fn = lambda qb: ivfpq.ivfpq_search_cuda(qb, *state, k, 64, **kw)  # noqa: E731
        s_k, i_k = fn(qs[0])
        first[f"{B}:{k}"] = (s_k.cpu(), i_k.cpu())
        q2 = qs[0][:2].contiguous()
        s_p, i_p = ivfpq.ivfpq_search(q2, *state, k, 64)
        out["mismatches_outside_ties"] += cs.check_topk(
            torch, None, None, None, s_k[:2], i_k[:2], s_p, i_p,
            judge=cs.adc_judge(torch, q2, *state))[2]
        out["ms"][f"{B}:{k}"] = cs._time_ms(torch, fn, qs)
    torch.save(first, save)
    from codegraph_tpu_torch.index.ivfpq import IVFPQIndex

    centroids, codes, ids, bias, books = state
    idx = IVFPQIndex(768, nlist=4096, nprobe=64, m=96, device="cuda")
    n_rows = int((ids >= 0).sum())
    idx.load_arrays(centroids, codes, ids, bias, fill.cpu().numpy(), codes.shape[2], n_rows,
                    n_rows - int(((ids >= 0) & (bias < cs.NEG_INF / 2)).sum()), books=books)
    out["search_ms"] = {}
    for B in (1, 1024):
        gq = torch.Generator(device="cuda").manual_seed(B)
        qs = [cs._unit(torch, torch.randn(B, 768, generator=gq, device="cuda")) for _ in range(8)]
        idx.search(qs[0], 10)  # warm
        times = []
        for qb in qs[1:]:
            t0 = time.perf_counter()
            idx.search(qb, 10)
            times.append((time.perf_counter() - t0) * 1e3)
        out["search_ms"][str(B)] = statistics.median(times)
    return out


def worker(root: str, kernel: str, rows: int, shapes) -> dict:
    """One turn: the kernel of the checkout at `root` on every shape."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    sys.path.remove(ROOT)
    sys.path.insert(0, os.path.abspath(root))
    from codegraph_tpu_torch.ops import quantize, topk

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2024)
    N, D = rows, 768
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=g, device=dev)[: N // 100]] = cs.NEG_INF
    flat = kernel in ("K2", "K2tc")
    dtype = torch.bfloat16 if kernel == "K2tc" else torch.float32
    if flat:
        x = cs._unit(torch, torch.randn(N, D, generator=g, device=dev)).to(dtype)
        fn = lambda qb, k: topk.streaming_topk_cuda_qmajor(qb, x, bias, k)  # noqa: E731
        module = topk.__file__
    else:
        xv = torch.empty((N, D), dtype=torch.int8, device=dev)
        xs = torch.empty(N, device=dev)
        for base in range(0, N, 131072):
            n = min(131072, N - base)
            xv[base: base + n], xs[base: base + n] = quantize.quantize_rows(
                cs._unit(torch, torch.randn(n, D, generator=g, device=dev)))
        fn = lambda qb, k: quantize.streaming_topk_int8_cuda_qmajor(  # noqa: E731
            qb[0], qb[1], xv, xs, bias, k)
        module = quantize.__file__
    out = {"root": root, "module": module, "ms": {}, "mismatches_outside_ties": 0}
    for B, k in shapes:
        qs = [cs._unit(torch, torch.randn(B, D, generator=g, device=dev)) for _ in range(7)]
        if flat:
            qs = [q.to(dtype) for q in qs]
            s_k, i_k = fn(qs[0], k)
            s_y, i_y = cs.yardstick(torch, qs[0], x, bias, k)
            out["mismatches_outside_ties"] += cs.check_topk(torch, qs[0], x, bias, s_k, i_k,
                                                            s_y, i_y)[2]
        else:
            qs = [quantize.quantize_rows(q) for q in qs]
            s_k, i_k = fn(qs[0], k)
            args = (qs[0][0][:4].contiguous(), qs[0][1][:4].contiguous(), xv, xs, bias)
            s_y, i_y = cs.int8_yardstick(torch, *args, k)
            out["mismatches_outside_ties"] += cs.check_topk(
                torch, None, None, None, s_k[:4], i_k[:4], s_y, i_y, judge=cs.int8_judge(*args))[2]
        out["ms"][f"{B}:{k}"] = cs._time_ms(torch, lambda qb: fn(qb, k), qs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--kernel", choices=sorted(DEFAULTS), default="K2")
    ap.add_argument("--rows", type=int)
    ap.add_argument("--shapes")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.rows = args.rows or DEFAULTS[args.kernel][0]
    args.shapes = args.shapes or DEFAULTS[args.kernel][1]
    shapes = [tuple(int(v) for v in s.split(":")) for s in args.shapes.split(",")]
    if args.worker:
        res = (worker_k8(args.worker, shapes, args.save) if args.kernel == "K8"
               else worker(args.worker, args.kernel, args.rows, shapes))
        print(json.dumps(res), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(cs.nvidia_smi_line(), flush=True)
    turns = {"other": [], "this": []}
    ok = True
    tmp = tempfile.mkdtemp(prefix="kernel_vs_checkout_")
    for t, name in enumerate(("other", "this", "this", "other")):
        root = args.other if name == "other" else ROOT
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), args.other,
                               "--kernel", args.kernel, "--rows", str(args.rows),
                               "--shapes", args.shapes, "--worker", root,
                               "--save", os.path.join(tmp, f"{t}_{name}.pt")],
                              capture_output=True, text=True)
        if proc.returncode:
            print(f"turn {name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        ok = ok and res["mismatches_outside_ties"] == 0
        turns[name].append(res)
        print(json.dumps({"turn": name, **res}), flush=True)
    saved = ({n: torch.load(os.path.join(tmp, f"{t}_{n}.pt"))
              for t, n in ((0, "other"), (1, "this"))} if args.kernel == "K8" else {})
    shutil.rmtree(tmp, ignore_errors=True)
    for key in turns["this"][0]["ms"]:
        row = {"kernel": args.kernel, "N": args.rows, "D": 768, "B:k": key,
               "other_ms": [t["ms"][key] for t in turns["other"]],
               "this_ms": [t["ms"][key] for t in turns["this"]]}
        if saved:  # the first batch of both checkouts, bit for bit
            (s_o, i_o), (s_t, i_t) = saved["other"][key], saved["this"][key]
            row["scores_equal"] = bool(torch.equal(s_o, s_t))
            row["ids_differ"] = int((i_o != i_t).sum())
            row["ids_differ_where_scores_differ"] = int(((i_o != i_t) & (s_o != s_t)).sum())
            ok = ok and row["scores_equal"]
        print(json.dumps(row), flush=True)
    if args.kernel == "K8":
        for B in turns["this"][0]["search_ms"]:
            print(json.dumps({"IVFPQIndex.search": {"B": int(B), "k": 10},
                              "other_ms": [t["search_ms"][B] for t in turns["other"]],
                              "this_ms": [t["search_ms"][B] for t in turns["this"]]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time one kernel of this checkout against the same kernel of another
checkout of the repo (for example the parent commit unpacked with `git
archive`), in turns, on one NVIDIA GPU.

    python3 tools/kernel_vs_checkout.py OTHER_DIR [--kernel K2|K6]
                                        [--rows N] [--shapes B:k,B:k,...]

K2 (`streaming_topk_cuda_qmajor`, csrc/flat_topk.cu) runs on a 1%
tombstoned f32 corpus of unit rows at D=768, 1,000,000 rows by default;
K6 (`streaming_topk_int8_cuda_qmajor`, csrc/int8_topk.cu) on the same
rows quantized to int8, 10,000,000 by default. Each turn is a process of
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
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


DEFAULTS = {"K2": (1_000_000, "32:30,64:30,64:300,1024:30"),
            "K6": (10_000_000, "64:100,64:300,256:100,256:300,1024:100,1024:300")}


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
    if kernel == "K2":
        x = cs._unit(torch, torch.randn(N, D, generator=g, device=dev))
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
        if kernel == "K2":
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
    args = ap.parse_args()
    args.rows = args.rows or DEFAULTS[args.kernel][0]
    args.shapes = args.shapes or DEFAULTS[args.kernel][1]
    shapes = [tuple(int(v) for v in s.split(":")) for s in args.shapes.split(",")]
    if args.worker:
        print(json.dumps(worker(args.worker, args.kernel, args.rows, shapes)), flush=True)
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
    for name in ("other", "this", "this", "other"):
        root = args.other if name == "other" else ROOT
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), args.other,
                               "--kernel", args.kernel, "--rows", str(args.rows),
                               "--shapes", args.shapes, "--worker", root],
                              capture_output=True, text=True)
        if proc.returncode:
            print(f"turn {name} failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}",
                  file=sys.stderr, flush=True)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        ok = ok and res["mismatches_outside_ties"] == 0
        turns[name].append(res)
        print(json.dumps({"turn": name, **res}), flush=True)
    for key in turns["this"][0]["ms"]:
        print(json.dumps({"kernel": args.kernel, "N": args.rows, "D": 768, "B:k": key,
                          "other_ms": [t["ms"][key] for t in turns["other"]],
                          "this_ms": [t["ms"][key] for t in turns["this"]]}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

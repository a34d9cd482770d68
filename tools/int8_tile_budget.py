#!/usr/bin/env python3
"""Time the port's int8 kernels K6 and K7 (csrc/int8_topk.cu) under two
shared-memory budgets for their query-tile choice, on one NVIDIA GPU.

    python3 tools/int8_tile_budget.py [--rows 10000000]

The tile is the largest whose lists, staging tiles and score tile fit the
budget (`ops/quantize.py` MMA_SMEM_BYTES): 112 KB lets two blocks share an
SM, 227 KB (all a block may have on an H100) gives one block a larger tile.
Prints one line per (budget, kernel, B, k): the tile, its shared memory and
the median ms over 5 batches (CUDA events), budgets in turns (a, b, a).
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex  # noqa: E402
from codegraph_tpu_torch.ops import quantize  # noqa: E402
from codegraph_tpu_torch.ops.topk import K2_LAYOUT, K3_LAYOUT  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    N, D = args.rows, 768
    g = torch.Generator(device=dev).manual_seed(2025)
    idx = Int8FlatIndex(D, rescore_dtype=None, device="cuda")
    idx.reserve(N)
    for base in range(0, N, 131072):
        idx.add(torch.randn(min(131072, N - base), D, generator=g, device=dev))
    xv, xs, _, bias = idx.arrays()
    xv, xs, bias = xv[:N], xs[:N], bias[:N]
    smem = quantize._lib().int8_topk_pass1_smem
    kernels = ((K2_LAYOUT, quantize.streaming_topk_int8_cuda_qmajor),
               (K3_LAYOUT, quantize.streaming_topk_int8_cuda_qres))
    for budget in (112 * 1024, 227 * 1024, 112 * 1024):
        quantize.MMA_SMEM_BYTES = budget
        for layout, fn in kernels:
            for B, k in ((256, 100), (256, 300), (1024, 100), (1024, 300)):
                tm = quantize.row_warps_tm(smem, layout, B, k, D, quantize.MMA_TMS, budget)
                batches = [quantize.quantize_rows(
                    cs._unit(torch, torch.randn(B, D, generator=g, device=dev))) for _ in range(5)]
                ms = cs._time_ms(torch, lambda b: fn(b[0], b[1], xv, xs, bias, k), batches)
                print(f"budget={budget} {fn.__name__} B={B} k={k} query_tile={8 * tm} "
                      f"smem={smem(layout, tm, k, D)} ms={ms:.3f}", flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

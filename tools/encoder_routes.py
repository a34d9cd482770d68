#!/usr/bin/env python3
"""Time the port's encoder forward with three routes for its products, on
one NVIDIA GPU, and show how far each lands from the shipped one.

    python3 tools/encoder_routes.py [--reps N]

The shipped route (`models/encoder.py` `_mm`) multiplies bf16 operands with
`torch.mm/bmm(..., out_dtype=torch.float32)`: tensor cores, f32 sums, an f32
result, as the JAX package's einsums with `preferred_element_type=f32`. The
two others: f32 products of the bf16 values (the same function on CUDA
cores; the CPU's route), and bf16 `torch.matmul` whose output is rounded to
bf16 before it is widened (the logits and the up-projection rounded). The
encoder is `checkpoints/encoder_r3_512.npz` (6 x 512, 16 heads). Each shape
runs on seeded random token ids with random lengths; for B > 1 the last row
is fully padded and must come out 0. Prints the card, then one JSON line
per (shape, route): the median ms of `--reps` forwards (CUDA events), the
max abs distance to the shipped route, and whether every value is finite.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((1, 64), (32, 64), (256, 64), (256, 128), (256, 192))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("encoder_routes: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from codegraph_tpu_torch.models import encoder as enc_mod
    from codegraph_tpu_torch.models.providers import EncoderProvider

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    prov = EncoderProvider(checkpoint=os.path.join(ROOT, "checkpoints", "encoder_r3_512.npz"),
                           device="cuda")
    shipped = enc_mod._mm
    routes = {
        "out_dtype (shipped)": shipped,
        "f32 products": lambda a, b: torch.matmul(a.float(), b.float()),
        "bf16 outputs": lambda a, b: torch.matmul(a, b).float(),
    }
    g = torch.Generator(device="cuda").manual_seed(0)
    try:
        for B, L in SHAPES:
            ids = torch.randint(0, prov.cfg.vocab_size, (B, L), generator=g, device="cuda")
            lens = torch.randint(1, L + 1, (B,), generator=g, device="cuda")
            mask = torch.arange(L, device="cuda")[None] < lens[:, None]
            if B > 1:
                mask[-1] = False
            ref = None
            for name, fn in routes.items():
                enc_mod._mm = fn
                out = enc_mod.encode(prov.params, ids, mask, prov.cfg)  # warm
                times = []
                for _ in range(args.reps):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = enc_mod.encode(prov.params, ids, mask, prov.cfg)
                    e1.record()
                    torch.cuda.synchronize()
                    times.append(e0.elapsed_time(e1))
                if ref is None:
                    ref = out
                print(json.dumps({
                    "B": B, "L": L, "route": name, "ms": statistics.median(times),
                    "max_abs_vs_shipped": float((out - ref).abs().max()),
                    "finite": bool(torch.isfinite(out).all()),
                    "padded_row_zero": bool((out[-1] == 0).all()) if B > 1 else None,
                }), flush=True)
    finally:
        enc_mod._mm = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())

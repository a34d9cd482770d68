"""An f32 tensor as three bf16 pieces, for exact f32 products on bf16
tensor cores.

A bf16 value times a bf16 value is exact in f32, and so is a piece of an
f32 value times a bf16 value when the pieces carry 8 significant bits
each. So an f32 query multiplies bf16 rows as three bf16 products summed
in f32 (the tensor-core scan kernels of `ops/topk.py`), and an f32
cotangent multiplies bf16 weights the same way (`models/encoder.py`
`_TensorCoreMM`).
"""

from __future__ import annotations

import torch


def split_bf16(t: torch.Tensor):
    """An f32 tensor as three bf16 tensors (hi, mid, lo) with hi + mid +
    lo == t: each takes the next 8 significant bits of what the ones
    before it left (every subtraction is exact in f32), so the three hold
    all 24 bits of t for 2**-110 <= |t| < 3.3961e38 and for 0. Outside
    that range: from half a step above bf16's largest finite value
    (3.3895e38) hi rounds to infinity, and below 2**-110 (7.7e-34, f32's
    subnormals included) the lowest bits of lo fall under bf16's smallest
    subnormal (2**-133) and are lost."""
    hi = t.to(torch.bfloat16)
    rest = t - hi
    mid = rest.to(torch.bfloat16)
    rest.sub_(mid)
    return hi, mid, rest.to(torch.bfloat16)


__all__ = ["split_bf16"]

"""Copy of `codegraph_tpu/core/padding.py` for the PyTorch port
(`combine_bias` is ported to tensors).

Static-shape padding/alignment utilities.

TPU/XLA requires static shapes; dynamic corpora are handled by padding to
hardware-aligned capacities plus validity masks (the reference gets dynamic
sizing free from HNSW/SurrealDB; we trade it for MXU-friendly layouts).
Lane width is 128; sublane depends on dtype (f32: 8, bf16: 16, int8: 32).
"""

from __future__ import annotations


import numpy as np
import torch

LANE = 128

SUBLANE = {"float32": 8, "bfloat16": 16, "int8": 32, "uint8": 32, "float16": 16}


def round_up(x: int, multiple: int) -> int:
    if multiple <= 0:
        return x
    return ((x + multiple - 1) // multiple) * multiple


def aligned_rows(n: int, dtype: str = "float32", tile_rows: int = 0) -> int:
    """Rows padded to at least the dtype sublane; optionally to a tile size."""
    base = SUBLANE.get(dtype, 8)
    m = max(base, tile_rows)
    return round_up(max(n, 1), m)


def aligned_cols(d: int) -> int:
    return round_up(max(d, 1), LANE)


def pad_rows(x: np.ndarray, n_pad: int, fill: float = 0.0) -> np.ndarray:
    """Pad axis 0 of x up to n_pad rows with `fill`."""
    n = x.shape[0]
    if n == n_pad:
        return x
    if n > n_pad:
        raise ValueError(f"cannot pad {n} rows down to {n_pad}")
    pad_width = [(0, n_pad - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad_width, constant_values=fill)


def pad_axis(x: np.ndarray, axis: int, size: int, fill: float = 0.0) -> np.ndarray:
    n = x.shape[axis]
    if n == size:
        return x
    if n > size:
        raise ValueError(f"cannot pad axis {axis} from {n} down to {size}")
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, size - n)
    return np.pad(x, pad_width, constant_values=fill)


def grow_capacity(needed: int, current: int, tile_rows: int, dtype: str = "float32") -> int:
    """Capacity growth policy: 1.5x geometric, tile-aligned. Keeps add()
    amortized O(1) device reallocations (analogue of the reference's
    segment append model, incremental.rs:86-150)."""
    if needed <= current:
        return current
    target = max(needed, int(current * 1.5))
    return aligned_rows(target, dtype, tile_rows)


def validity_mask(n_valid: int, n_pad: int) -> np.ndarray:
    m = np.zeros((n_pad,), dtype=np.bool_)
    m[:n_valid] = True
    return m


__all__ = [
    "LANE",
    "SUBLANE",
    "round_up",
    "aligned_rows",
    "aligned_cols",
    "pad_rows",
    "pad_axis",
    "grow_capacity",
    "validity_mask",
]


def combine_bias(base_bias: torch.Tensor, extra_bias, capacity: int) -> torch.Tensor:
    """live/tombstone bias + optional query-time filter mask (the
    device-side SearchFilters application shared by every index tier).

    extra_bias: [n] f32 numpy array or tensor (n <= capacity; 0 =
    allowed, NEG_INF = filtered), indexed by global row id. Rows beyond
    len(extra_bias) are treated as allowed. Returns a tensor on
    base_bias's device.
    """
    if extra_bias is None:
        return base_bias
    eb = torch.as_tensor(extra_bias, dtype=torch.float32).to(base_bias.device)
    if eb.shape[0] < capacity:
        eb = torch.nn.functional.pad(eb, (0, capacity - eb.shape[0]))
    return base_bias + eb[:capacity]

"""The least time of one search, from its shapes and the card's peaks.

Peaks are the NVIDIA H100 SXM data sheet's dense rates: 3.35 TB/s of HBM,
989 TFLOP/s in bf16, 1,979 TOP/s in int8, 67 TFLOP/s in f32 outside the
tensor cores. They assume the 700 W power limit; a run prints the card's
limit beside its shares.

The work of one `index.search` over N rows of width D, with B queries as
passed (padded batches included) and k results:

* bytes, each counted once: the rows in their stored precision, the
  per-row scales of an integer scan, the f32 bias (tombstones), the f32
  queries, the rescore copy's rows gathered (B x C of them, C = max(k,
  candidates)), the B x k scores and ids written back;
* operations: 2 B N D products in the scan's precision at its peak (f32
  queries over bf16 rows count as one bf16 product), and 2 B C D in the
  rescore's.

The least time is the larger of bytes over the memory rate and operations
over the peak rate. No correct implementation takes less.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def search_work(scoring: dict, n_rows: int, dim: int, batch: int, k: int):
    """(bytes, seconds of operations at peak) of one search."""
    scan, rescore = scoring["scan"], scoring.get("rescore")
    cand = max(k, int(scoring.get("candidates", k)))
    nbytes = n_rows * dim * ELEMENT_BYTES[scan] + n_rows * 4 + batch * dim * 4 + batch * k * 8
    if scan == "int8":
        nbytes += n_rows * 4
    op_s = 2.0 * batch * n_rows * dim / PEAK_OPS_PER_S[scan]
    if rescore:
        nbytes += batch * cand * dim * ELEMENT_BYTES[rescore]
        op_s += 2.0 * batch * cand * dim / PEAK_OPS_PER_S[rescore]
    return nbytes, op_s


def least_time_s(scoring: dict, n_rows: int, dim: int, batch: int, k: int) -> float:
    """The least time one search can take on the card, in seconds."""
    nbytes, op_s = search_work(scoring, n_rows, dim, batch, k)
    return max(nbytes / HBM_BYTES_PER_S, op_s)

"""The port's host library (`csrc/cghost.cpp`): ctypes bindings.

Copy of `codegraph_tpu/native.py:155-246` for the PyTorch port. The JAX
package runs three host loops in its g++ library (`native/cghost.cpp`):
the padded adjacency of the graph boost, the trigram preselection of edge
resolution and BM25 scoring from 2,000 docs. The port runs the same
functions from its own copy of that source, built with g++ at first use
into `codegraph_tpu_torch/_build/` (`ops/cuda_build.py` `build_host`). The
library is not optional: a failed build or load raises with the
compiler's output, where the JAX package falls back to Python. Each
function's plain version is the Python loop beside its caller
(`graph/csr.py` `padded_adjacency_plain`, `trigram_preselect_plain` below,
`search/bm25.py` `BM25Index._search_plain`); tests hold the two equal.

`calls` counts the calls of each function, so that a run can show that a
path went through the library.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ABI_VERSION = 2  # must match cg_abi_version() in csrc/cghost.cpp

calls: Dict[str, int] = {"padded_adjacency": 0, "trigram_preselect": 0, "bm25_score": 0}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from codegraph_tpu_torch.ops import cuda_build

        cdll = cuda_build.load_host("cghost")
        cdll.cg_abi_version.restype = ctypes.c_int64
        abi = int(cdll.cg_abi_version())
        if abi != ABI_VERSION:
            raise RuntimeError(f"csrc/cghost.cpp reports ABI {abi}, the bindings "
                               f"expect {ABI_VERSION}")
        cdll.cg_padded_adjacency.argtypes = [
            ctypes.c_int64,
            _i64p, _i32p, _i16p, _f32p,
            _i64p, _i32p, _i16p, _f32p,
            _i16p, ctypes.c_int64,
            ctypes.c_int64,
            _i32p, _f32p, _i16p, _i8p,
        ]
        cdll.cg_padded_adjacency.restype = None
        cdll.cg_trigram_preselect.argtypes = [
            ctypes.c_char_p, _i64p, ctypes.c_int64,
            ctypes.c_char_p, _i64p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int64,
            _i32p, _f32p,
        ]
        cdll.cg_trigram_preselect.restype = None
        cdll.cg_bm25_score.argtypes = [
            _i64p, _i32p, _i32p, ctypes.c_int64,
            _i32p, ctypes.c_int64, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int64,
            _i32p, _f32p,
        ]
        cdll.cg_bm25_score.restype = ctypes.c_int64
        _lib = cdll
        return _lib


def padded_adjacency_native(
    n_nodes: int,
    indptr: np.ndarray, indices: np.ndarray,
    etype: np.ndarray, weight: np.ndarray,
    r_indptr: np.ndarray, r_indices: np.ndarray,
    r_etype: np.ndarray, r_weight: np.ndarray,
    keep_etypes: Sequence[int],
    max_deg: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(nbr, wgt, etype, dir) [n_nodes, max_deg] of the symmetric union of
    the forward and reverse CSR (`CSRGraph.padded_adjacency`)."""
    cdll = lib()
    nbr = np.full((n_nodes, max_deg), -1, np.int32)
    wgt = np.zeros((n_nodes, max_deg), np.float32)
    et = np.full((n_nodes, max_deg), -1, np.int16)
    dirn = np.zeros((n_nodes, max_deg), np.int8)
    keep = np.asarray(list(keep_etypes), np.int16)
    calls["padded_adjacency"] += 1
    cdll.cg_padded_adjacency(
        n_nodes,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(etype, np.int16),
        np.ascontiguousarray(weight, np.float32),
        np.ascontiguousarray(r_indptr, np.int64),
        np.ascontiguousarray(r_indices, np.int32),
        np.ascontiguousarray(r_etype, np.int16),
        np.ascontiguousarray(r_weight, np.float32),
        keep, len(keep), max_deg, nbr, wgt, et, dirn,
    )
    return nbr, wgt, et, dirn


def _pack_strings(strings: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    offs = np.zeros((len(strings) + 1,), np.int64)
    parts: List[bytes] = []
    total = 0
    for i, s in enumerate(strings):
        b = s.encode("utf-8", errors="replace")
        parts.append(b)
        total += len(b)
        offs[i + 1] = total
    return b"".join(parts), offs


def trigram_preselect_native(
    targets: Sequence[str],
    symbols: Sequence[str],
    threshold: float = 0.3,
    top_j: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (idx [n_targets, top_j] into symbols with -1 pads, scores), the
    candidates of each target by trigram jaccard, highest first."""
    idx = np.full((len(targets), top_j), -1, np.int32)
    score = np.zeros((len(targets), top_j), np.float32)
    if not targets or not symbols:
        return idx, score
    cdll = lib()
    tbuf, toff = _pack_strings(targets)
    sbuf, soff = _pack_strings(symbols)
    calls["trigram_preselect"] += 1
    cdll.cg_trigram_preselect(
        tbuf, toff, len(targets), sbuf, soff, len(symbols),
        threshold, top_j, idx, score,
    )
    return idx, score


def _fnv_trigrams(s: str) -> set:
    """The library's trigrams of one string: the 32-bit FNV-1a hash of
    each 3-byte window of its UTF-8 bytes (a string of at most 2 bytes is
    one, its own hash); case is kept."""
    b = s.encode("utf-8", errors="replace")
    windows = [b] if len(b) <= 2 else [b[i:i + 3] for i in range(len(b) - 2)]
    out = set()
    for w in windows:
        h = 2166136261
        for c in w:
            h = ((h ^ c) * 16777619) & 0xFFFFFFFF
        out.add(h)
    return out


def trigram_preselect_plain(
    targets: Sequence[str],
    symbols: Sequence[str],
    threshold: float = 0.3,
    top_j: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """`trigram_preselect_native` in plain Python: the same trigrams and f32
    jaccard; ties in symbol order (the library's order of ties is its hash
    table's)."""
    idx = np.full((len(targets), top_j), -1, np.int32)
    score = np.zeros((len(targets), top_j), np.float32)
    sym = [_fnv_trigrams(s) for s in symbols]
    inv: Dict[int, List[int]] = {}
    for j, tris in enumerate(sym):
        for t in tris:
            inv.setdefault(t, []).append(j)
    for i, target in enumerate(targets):
        tgt = _fnv_trigrams(target)
        overlap: Dict[int, int] = {}
        for t in tgt:
            for j in inv.get(t, ()):
                overlap[j] = overlap.get(j, 0) + 1
        scored = []
        for j, n in overlap.items():
            jac = np.float32(n) / np.float32(len(tgt) + len(sym[j]) - n)
            if float(jac) >= threshold:
                scored.append((-float(jac), j))
        scored.sort()
        for k, (neg, j) in enumerate(scored[:top_j]):
            idx[i, k] = j
            score[i, k] = -neg
    return idx, score


def bm25_score_native(
    post_off: np.ndarray, post_doc: np.ndarray, post_tf: np.ndarray,
    doc_len: np.ndarray, avg_len: float,
    k1: float, b: float, top_n: int,
    n_docs: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Okapi BM25 over postings packed per query term (CSR: post_off [T+1],
    post_doc, post_tf), doc_len an id -> length table, n_docs the corpus
    size for the IDF term -> the top_n (doc ids, f32 scores), highest
    first."""
    cdll = lib()
    out_doc = np.zeros((top_n,), np.int32)
    out_score = np.zeros((top_n,), np.float32)
    calls["bm25_score"] += 1
    n = cdll.cg_bm25_score(
        np.ascontiguousarray(post_off, np.int64),
        np.ascontiguousarray(post_doc, np.int32),
        np.ascontiguousarray(post_tf, np.int32),
        len(post_off) - 1,
        np.ascontiguousarray(doc_len, np.int32),
        int(n_docs), avg_len, k1, b, top_n, out_doc, out_score,
    )
    return out_doc[:n], out_score[:n]


__all__ = [
    "ABI_VERSION",
    "bm25_score_native",
    "calls",
    "lib",
    "padded_adjacency_native",
    "trigram_preselect_native",
    "trigram_preselect_plain",
]

"""Copy of `codegraph_tpu/models/hash_embedder.py` for the PyTorch port.

Deterministic feature-hashing embedder (no-model fallback).

Re-design of the reference's `simple_text_embedding` hash fallback
(crates/codegraph-mcp/src/indexer.rs:4607): when no encoder weights or
provider are available, texts embed via signed feature hashing of word
and character n-grams. Fully deterministic, dimension-agnostic, and good
enough for lexical-similarity retrieval in tests/CLI smoke paths.
"""

from __future__ import annotations

import hashlib
import re
from typing import Iterable, List

import numpy as np

_TOKEN_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*|\d+|[^\sA-Za-z0-9_]")


def _features(text: str) -> Iterable[str]:
    toks = _TOKEN_RE.findall(text.lower())
    for t in toks:
        yield "w:" + t
    for a, b in zip(toks, toks[1:]):
        yield "b:" + a + "\x1f" + b
    # char trigrams catch identifier-fragment matches (the reference's
    # trigram-jaccard preselection, indexer.rs:2673-2900, uses the same idea)
    flat = "".join(toks)
    for i in range(len(flat) - 2):
        yield "c:" + flat[i : i + 3]


def _bucket_sign(feat: str, dim: int) -> tuple:
    h = hashlib.blake2b(feat.encode(), digest_size=8).digest()
    v = int.from_bytes(h, "little")
    return (v >> 1) % dim, 1.0 if (v & 1) else -1.0


def hash_embed_texts(texts: List[str], dim: int = 384) -> np.ndarray:
    """-> [N, dim] f32, L2-normalized rows (zero rows for empty texts)."""
    out = np.zeros((len(texts), dim), np.float32)
    for i, text in enumerate(texts):
        for feat in _features(text):
            b, s = _bucket_sign(feat, dim)
            out[i, b] += s
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    np.divide(out, norms, out=out, where=norms > 1e-12)
    return out


__all__ = ["hash_embed_texts"]

"""Copy of `codegraph_tpu/search/bm25.py` for the PyTorch port.

BM25 full-text scorer over node/chunk texts (host side).

Replaces the reference's in-database BM25 analyzers + text candidates
query (schema/codegraph.surql:420-447: SurrealDB SEARCH ANALYZER over
nodes.content/name). Classic Okapi BM25 (k1=1.2, b=0.75) over a
code-aware token stream: identifiers split on snake/camel case so a
query for "parse file" hits `parse_file_with_edges`. The posting lists
are numpy arrays; scoring a query is a few vectorized gathers, and the
hybrid layer consumes scores for the 0.9/0.1 mix (surql:470-472).
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from codegraph_tpu_torch.native import bm25_score_native

_WORD_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*|\d+")
_CAMEL_RE = re.compile(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])")

# tiny stop set for code search (the reference filters stop words in its
# semantic matcher too, indexer.rs:2673)
_STOP = {
    "the", "a", "an", "of", "to", "in", "is", "and", "or", "for", "на",
    "this", "that", "it", "be", "as", "at", "by", "with", "from",
}


def tokenize(text: str) -> List[str]:
    """Lower-cased word tokens with snake_case / camelCase splitting."""
    out: List[str] = []
    for w in _WORD_RE.findall(text):
        parts = [p for chunk in w.split("_") for p in _CAMEL_RE.split(chunk) if p]
        for p in parts:
            p = p.lower()
            if p and p not in _STOP:
                out.append(p)
    return out


class BM25Index:
    """Incremental BM25 with tombstone deletes (doc ids are caller rows)."""

    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self.postings: Dict[str, Dict[int, int]] = {}  # term -> {doc: tf}
        self.doc_len: Dict[int, int] = {}
        self.total_len = 0

    def add(self, doc_id: int, text: str) -> None:
        toks = tokenize(text)
        if doc_id in self.doc_len:
            self.remove(doc_id)
        self.doc_len[doc_id] = len(toks)
        self.total_len += len(toks)
        for term, tf in Counter(toks).items():
            self.postings.setdefault(term, {})[doc_id] = tf

    def add_batch(self, docs: Sequence[Tuple[int, str]]) -> None:
        for doc_id, text in docs:
            self.add(doc_id, text)

    def remove(self, doc_id: int) -> None:
        n = self.doc_len.pop(doc_id, None)
        if n is None:
            return
        self.total_len -= n
        for term_docs in self.postings.values():
            term_docs.pop(doc_id, None)

    @property
    def n_docs(self) -> int:
        return len(self.doc_len)

    def _idf(self, term: str) -> float:
        df = len(self.postings.get(term, ()))
        if df == 0:
            return 0.0
        return math.log(1.0 + (self.n_docs - df + 0.5) / (df + 0.5))

    # from this corpus size the host library scores (the JAX package's
    # threshold: below it the packing costs more than the loop)
    NATIVE_THRESHOLD = 2000

    def search(self, query: str, limit: int = 50) -> List[Tuple[int, float]]:
        """Top-`limit` (doc_id, bm25_score), descending."""
        if self.n_docs == 0:
            return []
        avg_len = self.total_len / self.n_docs
        terms = [t for t in set(tokenize(query)) if t in self.postings]
        if not terms:
            return []
        if self.n_docs >= self.NATIVE_THRESHOLD:
            return self._search_native(terms, avg_len, limit)
        return self._search_plain(terms, avg_len, limit)

    def _search_plain(self, terms, avg_len, limit) -> List[Tuple[int, float]]:
        """The scores in Python (f64 sums), ties in posting order: the path
        below NATIVE_THRESHOLD, and the plain version of `_search_native`."""
        scores: Dict[int, float] = {}
        for term in terms:
            idf = self._idf(term)
            if idf == 0.0:
                continue
            for doc_id, tf in self.postings[term].items():
                dl = self.doc_len[doc_id]
                denom = tf + self.k1 * (1 - self.b + self.b * dl / avg_len)
                scores[doc_id] = scores.get(doc_id, 0.0) + idf * tf * (self.k1 + 1) / denom
        top = sorted(scores.items(), key=lambda kv: -kv[1])[:limit]
        return top

    def _search_native(self, terms, avg_len, limit) -> List[Tuple[int, float]]:
        """Score in the host library over packed per-term postings: f64
        sums, f32 scores, ties in its hash table's order."""
        post_off = [0]
        post_doc: List[int] = []
        post_tf: List[int] = []
        max_doc = -1
        for t in terms:
            docs_tf = self.postings.get(t, {})
            for d, tf in docs_tf.items():
                post_doc.append(d)
                post_tf.append(tf)
                if d > max_doc:
                    max_doc = d
            post_off.append(len(post_doc))
        if max_doc < 0:
            return []
        doc_len = np.zeros((max_doc + 1,), np.int32)
        for d, n in self.doc_len.items():
            if d <= max_doc:
                doc_len[d] = n
        out_doc, out_score = bm25_score_native(
            np.asarray(post_off, np.int64), np.asarray(post_doc, np.int32),
            np.asarray(post_tf, np.int32), doc_len, avg_len,
            self.k1, self.b, limit, n_docs=self.n_docs,
        )
        return [(int(d), float(s)) for d, s in zip(out_doc, out_score)]

    def scores_for(self, query: str, doc_ids: Sequence[int]) -> np.ndarray:
        """BM25 scores for specific docs (the hybrid mix needs aligned
        scores for the vector candidates), normalized to [0, 1] by the
        query's max score."""
        results = dict(self.search(query, limit=max(200, len(doc_ids))))
        if not results:
            return np.zeros((len(doc_ids),), np.float32)
        mx = max(results.values())
        return np.asarray(
            [results.get(int(d), 0.0) / mx if mx > 0 else 0.0 for d in doc_ids],
            np.float32,
        )


__all__ = ["BM25Index", "tokenize"]

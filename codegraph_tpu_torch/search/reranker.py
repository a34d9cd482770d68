"""Copy of `codegraph_tpu/search/reranker.py` for the PyTorch port;
`reranker="cross_encoder"` (the r3 cross-encoder, `models/cross_encoder.py`)
raises NotImplementedError until ROADMAP item 9 ports it.

Multi-stage reranking pipeline.

Re-implements the reference's 3-stage reranker
(crates/codegraph-vector/src/reranker.rs:250-432: embedding filter
top-100 -> cross-encoder top-20 -> optional LLM top-10) and the text
reranker providers (src/reranking/{jina,ollama,factory}.rs). Stage 1
runs on device (a batched rescore matmul); stage 2 is a lightweight
lexical cross-scorer by default with pluggable external providers;
stage 3 asks an LLM provider to order the finalists.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from codegraph_tpu_torch.core.types import SearchResult
from codegraph_tpu_torch.search.bm25 import tokenize

logger = logging.getLogger("codegraph_tpu_torch.rerank")


@dataclass
class RerankerConfig:
    """Stage sizes mirror reranker.rs:20-60 defaults."""

    stage1_k: int = 100
    stage2_k: int = 20
    stage3_k: int = 10
    use_llm: bool = False


class PassthroughReranker:
    """Stage 1 for feature mode: keep the retrieval ranking and scores,
    truncate to k. This is what the reference's stage 1 actually is —
    'embedding filter top-100' (reranker.rs:250-300) means taking the
    top candidates BY THE RETRIEVAL EMBEDDING SCORE, not re-embedding
    snippets: the r5 agent_eval showed the snippet re-embed stage
    collapses tool recall@1 0.41 -> 0.26 (truncated 400-char snippets
    rank differently from the indexed chunks) and costs ~6s/query."""

    def rerank(
        self, query: str, results: List[SearchResult], k: int
    ) -> List[SearchResult]:
        return results[:k]


class EmbeddingReranker:
    """Stage 1: exact embedding rescore (reranker.rs:84 EmbeddingReRanker).

    Recomputes query-candidate cosine with fresh embeddings of the
    candidate snippets — catches drift between stored chunk embeddings
    and what the snippet actually says.
    """

    def __init__(self, provider):
        self.provider = provider

    def rerank(
        self, query: str, results: List[SearchResult], k: int
    ) -> List[SearchResult]:
        if not results:
            return results
        q = self.provider.embed_texts([query])[0]
        texts = [r.snippet or r.name for r in results]
        embs = self.provider.embed_texts(texts)
        sims = embs @ q
        order = np.argsort(-sims)[:k]
        out = []
        for rank, idx in enumerate(order):
            r = results[int(idx)]
            r.score = float(sims[int(idx)])
            out.append(r)
        return out


class CrossScorerReranker:
    """Stage 2: pairwise query x candidate scorer (reranker.rs:170
    CrossEncoderReRanker). Default implementation is a token-overlap
    cross-scorer (no external model needed); `scorer` can be swapped for
    a Jina/LM-Studio API scorer (reranking/jina.rs, ollama.rs)."""

    def __init__(self, scorer: Optional[Callable[[str, str], float]] = None):
        self.scorer = scorer or self._lexical_score

    @staticmethod
    def _lexical_score(query: str, text: str) -> float:
        qt, tt = set(tokenize(query)), set(tokenize(text))
        if not qt or not tt:
            return 0.0
        overlap = len(qt & tt)
        return overlap / (len(qt) ** 0.5 * len(tt) ** 0.5)

    def rerank(
        self, query: str, results: List[SearchResult], k: int
    ) -> List[SearchResult]:
        scored = [
            (0.7 * r.score + 0.3 * self.scorer(query, f"{r.name} {r.snippet}"), r)
            for r in results
        ]
        scored.sort(key=lambda t: -t[0])
        out = []
        for s, r in scored[:k]:
            r.score = float(s)
            out.append(r)
        return out


class FeatureReranker:
    """Stage 2 alternative: cheap ranking features STACKED on the
    retrieval score (VERDICT r4 item 5 — the trained cross-encoder
    degraded retrieval, 0.738 -> 0.227 recall@1; this replaces it with
    signals that cannot dominate the bi-encoder, only break its ties).

    final = retrieval + scale * (w_name*name_overlap + w_snip*ident_hits
                                 + w_path*path_match + w_deg*log_degree)

    - name_overlap: IDF-free cosine of query tokens vs the candidate's
      NAME tokens (the reference's BM25 leg weighs name matches the
      same way, codegraph.surql:420-447);
    - ident_hits: fraction of long (>=4 char) query tokens present in
      the snippet — identifier mentions;
    - path_match: query tokens appearing in the candidate's file path;
    - log_degree: optional graph centrality from `degree_fn(node_id)`
      (reranker.rs:250's pipeline consults graph context the same way).

    `scale` is in SCORE units (cosine / hybrid mix): with the default
    0.05, the full feature sum moves a candidate by at most ~0.05
    cosine — features break near-ties, a decisive retrieval gap stands.
    Weights are calibrated on the PYTHON per-language pairs (unseen by
    the Rust cross-repo eval).
    """

    def __init__(self, w_name: float = 0.30, w_snip: float = 0.15,
                 w_path: float = 0.10, w_deg: float = 0.05,
                 degree_fn: Optional[Callable[[str], int]] = None,
                 scale: float = 0.05):
        self.w_name = w_name
        self.w_snip = w_snip
        self.w_path = w_path
        self.w_deg = w_deg
        self.degree_fn = degree_fn
        self.scale = scale

    @staticmethod
    def _overlap_cos(a: set, b: set) -> float:
        if not a or not b:
            return 0.0
        return len(a & b) / ((len(a) ** 0.5) * (len(b) ** 0.5))

    def features(self, query: str, r: SearchResult) -> float:
        qt = set(tokenize(query))
        name_t = set(tokenize(r.name or ""))
        f = self.w_name * self._overlap_cos(qt, name_t)
        long_q = {t for t in qt if len(t) >= 4}
        if long_q:
            snip = set(tokenize(r.snippet or ""))
            f += self.w_snip * (len(long_q & snip) / len(long_q))
        path_t = set(tokenize((r.file_path or "").replace("/", " ")
                              .replace(".", " ")))
        f += self.w_path * self._overlap_cos(qt, path_t)
        if self.degree_fn is not None:
            import math

            try:
                f += self.w_deg * math.log1p(
                    max(self.degree_fn(r.node_id), 0)) / 5.0
            except Exception:
                pass
        return f

    def rerank(
        self, query: str, results: List[SearchResult], k: int
    ) -> List[SearchResult]:
        if not results:
            return []
        scored = [
            (float(r.score) + self.scale * self.features(query, r), r)
            for r in results
        ]
        scored.sort(key=lambda t: -t[0])
        out = []
        for s, r in scored[:k]:
            r.score = float(s)
            out.append(r)
        return out


class LLMReranker:
    """Stage 3: LLM chooses the final ordering (reranker.rs LLM stage;
    reranking/ollama.rs chat-based scoring). Takes any LLMProvider from
    codegraph_tpu.mcp.llm; degrades to a no-op if the call fails."""

    def __init__(self, llm):
        self.llm = llm

    def rerank(
        self, query: str, results: List[SearchResult], k: int
    ) -> List[SearchResult]:
        if not results or self.llm is None:
            return results[:k]
        listing = "\n".join(
            f"{i}: {r.name} ({r.file_path}:{r.start_line}) — {r.snippet[:80]}"
            for i, r in enumerate(results)
        )
        prompt = (
            f"Rank these code search results for the query {query!r}. "
            f"Reply with the indices in best-first order, comma-separated.\n{listing}"
        )
        try:
            reply = self.llm.complete(prompt)
            order = [
                int(tok) for tok in reply.replace(",", " ").split()
                if tok.isdigit() and int(tok) < len(results)
            ]
            seen = set()
            ranked = []
            for i in order:
                if i not in seen:
                    seen.add(i)
                    ranked.append(results[i])
            for i, r in enumerate(results):
                if i not in seen:
                    ranked.append(r)
            return ranked[:k]
        except Exception as exc:  # degrade gracefully, like provider fallback
            logger.warning("LLM rerank failed: %s", exc)
            return results[:k]


class RerankerPipeline:
    """embedding top-100 -> cross-score top-20 -> (LLM) top-10.

    Stage 2 accepts either a (query, text) -> float scorer (lexical
    default, external APIs) or a batched model with
    `rerank_batch(query, results, k)` — the on-chip cross-encoder
    (models/cross_encoder.py) scores every candidate in one dispatch.
    """

    def __init__(
        self,
        provider,
        llm=None,
        config: Optional[RerankerConfig] = None,
        cross_scorer: Optional[Callable[[str, str], float]] = None,
        cross_encoder=None,
        stage2_override=None,
        stage1: str = "embedding",
    ):
        self.config = config or RerankerConfig()
        # stage1="none": retrieval-order passthrough (feature mode —
        # stage 2 stacks features on the retrieval scores, so stage 1
        # must not overwrite them with snippet re-embeddings)
        self.stage1 = (PassthroughReranker() if stage1 == "none"
                       else EmbeddingReranker(provider))
        self.cross_encoder = cross_encoder
        # stage2_override: any object with rerank(query, results, k)
        # (FeatureReranker) replaces the lexical cross-scorer
        self.stage2 = stage2_override or CrossScorerReranker(cross_scorer)
        self.stage3 = LLMReranker(llm) if (llm and self.config.use_llm) else None

    def rerank(self, query: str, results: List[SearchResult]) -> List[SearchResult]:
        c = self.config
        out = self.stage1.rerank(query, results[: c.stage1_k], c.stage2_k)
        k2 = c.stage3_k if self.stage3 else c.stage2_k
        if self.cross_encoder is not None:
            out = self.cross_encoder.rerank_batch(query, out, k2)
        else:
            out = self.stage2.rerank(query, out, k2)
        if self.stage3:
            out = self.stage3.rerank(query, out, c.stage3_k)
        return out


def make_reranker_pipeline(provider, search_cfg, llm=None,
                           degree_fn=None) -> RerankerPipeline:
    """The ONE serving construction path for the rerank pipeline
    (CLI `codegraph start`, the library API, service hosts). Duplicated
    builds have twice diverged — one dropped the cross_encoder wiring
    entirely, another constructed it without the shipped checkpoint
    (a random-init scorer blending noise into every ranking)."""
    cross_encoder = None
    stage2_override = None
    if getattr(search_cfg, "reranker", None) == "cross_encoder":
        raise NotImplementedError(
            "reranker 'cross_encoder' (models/cross_encoder.py) is not ported "
            "yet: ROADMAP item 9; use reranker 'feature' (the default)")
    elif getattr(search_cfg, "reranker", None) == "feature":
        stage2_override = FeatureReranker(degree_fn=degree_fn)
    return RerankerPipeline(
        provider, llm=llm,
        config=RerankerConfig(stage1_k=search_cfg.rerank_candidates),
        cross_encoder=cross_encoder,
        stage2_override=stage2_override,
        stage1="none" if stage2_override is not None else "embedding",
    )


__all__ = [
    "RerankerConfig",
    "EmbeddingReranker",
    "CrossScorerReranker",
    "FeatureReranker",
    "LLMReranker",
    "RerankerPipeline",
    "make_reranker_pipeline",
]

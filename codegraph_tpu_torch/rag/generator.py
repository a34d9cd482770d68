"""Copy of `codegraph_tpu/rag/generator.py` for the PyTorch port.

Answer synthesis: template / extractive / quoting ladder + validation.

Reference: crates/codegraph-vector/src/rag/response_generator.rs:59-934 —
GenerationConfig (:37-57), source selection + confidence (:220-244),
synthesis ladder template->extractive->quote (:246-264), intent-pattern
template library (:715-735), keyword-overlap answer validation (:456-505),
context-relevance scoring + synthesize_from_contexts (:508-595), and the
degradation responses (no results / low confidence, :604-713). Redesigned
here around the rebuild's SearchResult records (file:line provenance is
first-class, so citations are real paths instead of node snippets) with
an optional LLM polish stage on top (the reference keeps LLM generation
in codegraph-ai; here a configured llm upgrades the method to HYBRID).
"""

from __future__ import annotations

import enum
import logging
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from codegraph_tpu_torch.core.types import SearchResult
from codegraph_tpu_torch.rag.query_processor import ProcessedQuery, QueryType

logger = logging.getLogger("codegraph_tpu_torch_torch.rag")


class GenerationMethod(enum.Enum):
    """How the answer text was produced (response_generator.rs:29-35)."""

    TEMPLATE = "template"        # intent pattern matched a template
    EXTRACTIVE = "extractive"    # intro + numbered key findings
    QUOTE = "quote"              # direct snippet quoting
    HYBRID = "hybrid"            # LLM polish over extractive evidence
    DEGRADED = "degraded"        # no-results / low-confidence fallback


@dataclass
class GenerationConfig:
    """response_generator.rs:37-57 defaults, kept verbatim where they are
    plain numbers (max_sources 5, min confidence 0.3, 1000-char cap)."""

    max_sources: int = 5
    min_confidence_threshold: float = 0.3
    use_extractive_synthesis: bool = True
    include_code_examples: bool = True
    max_response_length: int = 1000
    enable_answer_validation: bool = True


@dataclass
class GeneratedResponse:
    answer: str
    confidence: float = 0.0
    sources: List[dict] = field(default_factory=list)
    method: GenerationMethod = GenerationMethod.DEGRADED
    processing_time_ms: float = 0.0
    used_llm: bool = False
    valid: bool = True
    validation: dict = field(default_factory=dict)  # per-check detail


# intent-pattern templates (response_generator.rs:715-735 keys a template
# on a substring of the query; same mechanism, own prose). {name}/{kind}/
# {where}/{snippet} fill from the top source.
_INTENT_TEMPLATES: List[Tuple[str, str]] = [
    ("how", "To do this, use {name} ({kind}, {where}):\n\n{snippet}"),
    ("what", "{name} is a {kind} at {where}:\n\n{snippet}"),
    ("where", "{name} lives at {where} ({kind}):\n\n{snippet}"),
    ("find", "Best match: {name} ({kind}) at {where}:\n\n{snippet}"),
    ("error", "The error-handling path here is {name} ({where}):\n\n{snippet}"),
]

# per-QueryType extractive introductions
_INTROS = {
    QueryType.CODE_SEARCH: "Most relevant code for {q!r}:",
    QueryType.EXPLANATION: "Context gathered for {q!r}:",
    QueryType.DEBUGGING: "Code paths likely involved in {q!r}:",
    QueryType.ARCHITECTURE: "Structural context for {q!r}:",
    QueryType.USAGE: "Usage sites and definitions for {q!r}:",
    QueryType.GENERAL: "Results for {q!r}:",
}

_GENERIC_PHRASES = ("i don't know", "no information", "cannot determine",
                    "unable to find")
_STOP_WORDS = frozenset(
    "the and for with that this from are was were has have had how what "
    "where when which who why you your can could should would does did "
    "not all any each may might must our their them then than into out "
    "about over under between because while after before against".split()
)

_WORD_RE = re.compile(r"[a-z0-9_]+")


def _keywords(text: str) -> Set[str]:
    """Lowercased >2-char non-stop-word tokens; identifiers also split on
    underscores/camelCase so `compute_total` grounds a query about
    "compute" (response_generator.rs:589-652 normalizes similarly)."""
    out: Set[str] = set()
    decamel = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", " ", text)
    for w in _WORD_RE.findall(decamel.lower()):
        if len(w) > 2 and w not in _STOP_WORDS:
            out.add(w)
            for part in w.split("_"):
                if len(part) > 2 and part not in _STOP_WORDS:
                    out.add(part)
    return out


class ResponseGenerator:
    def __init__(self, llm=None, config: Optional[GenerationConfig] = None):
        self.llm = llm
        self.config = config or GenerationConfig()

    # -- public entry points ------------------------------------------------

    def generate(
        self, pq: ProcessedQuery, results: List[SearchResult]
    ) -> GeneratedResponse:
        t0 = time.perf_counter()
        cfg = self.config
        if not results:
            return self._finish(GeneratedResponse(
                answer=f"No relevant code found for {pq.raw!r}. Try "
                       "different keywords or index more of the project.",
                valid=False, method=GenerationMethod.DEGRADED), t0)

        selected = self._select_sources(results)
        confidence = self._confidence(selected)
        sources = self._source_refs(selected or results[: cfg.max_sources])
        if not selected or confidence < cfg.min_confidence_threshold:
            # low-confidence degradation (response_generator.rs:670-688):
            # still surface what WAS found, flagged, instead of nothing
            return self._finish(GeneratedResponse(
                answer=(f"Possibly relevant (low confidence) for "
                        f"{pq.raw!r}:\n" +
                        self._listing(results[: cfg.max_sources])),
                confidence=confidence, sources=sources,
                method=GenerationMethod.DEGRADED, valid=True,
                validation={"low_confidence": True}), t0)

        answer, method = self._synthesize(pq, selected)
        used_llm = False
        if self.llm is not None and getattr(
                self.llm, "is_available", lambda: False)():
            try:
                answer = self.llm.complete(
                    f"Question: {pq.raw}\nEvidence:\n"
                    f"{self._listing(selected)}\n\n"
                    "Answer the question grounded ONLY in the evidence, "
                    "citing file:line."
                )
                used_llm, method = True, GenerationMethod.HYBRID
            except Exception as exc:
                logger.warning("LLM generation failed: %s", exc)

        checks: Dict[str, bool] = {}
        valid = True
        if cfg.enable_answer_validation:
            checks = self._validate(answer, pq.raw, selected)
            valid = all(checks.values())
        return self._finish(GeneratedResponse(
            answer=answer, confidence=confidence, sources=sources,
            method=method, used_llm=used_llm, valid=valid,
            validation=checks), t0)

    def generate_from_contexts(
        self, query: str, contexts: Sequence[str]
    ) -> GeneratedResponse:
        """Synthesize from raw text contexts (no SearchResults), scoring
        each context's relevance first (response_generator.rs:146-218
        generate_validated_response + :508 calculate_context_relevance)."""
        t0 = time.perf_counter()
        cfg = self.config
        if not contexts:
            return self._finish(GeneratedResponse(
                answer=f"No context provided for {query!r}.", valid=False),
                t0)
        scores = self._context_relevance(query, contexts)
        relevant = [(c, s) for c, s in zip(contexts, scores)
                    if s >= cfg.min_confidence_threshold]
        if not relevant:
            return self._finish(GeneratedResponse(
                answer=f"No relevant context found for {query!r}.",
                confidence=0.1, valid=False), t0)
        confidence = sum(s for _, s in relevant) / len(relevant)
        parts = [f"From the available context, regarding {query!r}:"]
        for i, (ctx, s) in enumerate(relevant[:3]):
            tag = ("highly relevant" if s > 0.8
                   else "relevant" if s > 0.6 else "possibly relevant")
            parts.append(f"{i + 1}. ({tag}, {s:.0%}) {ctx[:300]}")
        answer = "\n\n".join(parts)
        sources = [{"node_id": f"context_{i}", "name": f"context {i + 1}",
                    "file": "", "line": 0, "score": round(float(s), 4),
                    "snippet": c[:200]}
                   for i, (c, s) in enumerate(relevant)]
        checks = self._validate_text(answer, query, [c for c, _ in relevant])
        return self._finish(GeneratedResponse(
            answer=answer, confidence=confidence, sources=sources,
            method=GenerationMethod.HYBRID, valid=all(checks.values()),
            validation=checks), t0)

    # -- selection / confidence ---------------------------------------------

    def _select_sources(self, results: List[SearchResult]):
        cfg = self.config
        return [r for r in results[: cfg.max_sources]
                if float(r.score) >= cfg.min_confidence_threshold]

    @staticmethod
    def _confidence(selected) -> float:
        """Average score with a small multi-source corroboration boost
        (response_generator.rs:228-244)."""
        if not selected:
            return 0.0
        avg = sum(float(r.score) for r in selected) / len(selected)
        boost = (0.8 if len(selected) == 1
                 else 1.0 if len(selected) <= 3
                 else 1.1 if len(selected) <= 5 else 1.2)
        return min(1.0, avg * boost)

    @staticmethod
    def _source_refs(selected) -> List[dict]:
        return [
            {"node_id": getattr(r, "node_id", ""), "name": r.name,
             "file": r.file_path, "line": r.start_line,
             "score": round(float(r.score), 4),
             "snippet": (r.snippet or "")[:200]}
            for r in selected
        ]

    # -- synthesis ladder ----------------------------------------------------

    def _synthesize(self, pq: ProcessedQuery, selected):
        answer = self._try_template(pq, selected)
        if answer is not None:
            return answer, GenerationMethod.TEMPLATE
        if self.config.use_extractive_synthesis:
            return self._extractive(pq, selected), GenerationMethod.EXTRACTIVE
        return self._quote(selected), GenerationMethod.QUOTE

    def _try_template(self, pq: ProcessedQuery, selected) -> Optional[str]:
        q = pq.raw.lower()
        top = selected[0]
        for pattern, template in _INTENT_TEMPLATES:
            if pattern in q:
                snippet = ((top.snippet or "")[:200]
                           if self.config.include_code_examples else "")
                answer = template.format(
                    name=top.name,
                    kind=getattr(top, "node_type", None) or "symbol",
                    where=f"{top.file_path}:{top.start_line}",
                    snippet=snippet,
                ).rstrip()
                if len(selected) > 1:
                    answer += "\n\nRelated:\n" + "\n".join(
                        f"- {r.name} ({r.file_path}:{r.start_line})"
                        for r in selected[1:4])
                return self._truncate(answer)
        return None

    def _extractive(self, pq: ProcessedQuery, selected) -> str:
        parts = [_INTROS.get(pq.query_type,
                             _INTROS[QueryType.GENERAL]).format(q=pq.raw)]
        for i, r in enumerate(selected[:3]):
            kind = getattr(r, "node_type", None) or "symbol"
            line = f"{i + 1}. **{r.name}** ({kind}, " \
                   f"{r.file_path}:{r.start_line})"
            if self.config.include_code_examples and r.snippet:
                line += f": {r.snippet[:160]}"
            parts.append(line)
        if len(selected) > 3:
            parts.append("Also relevant: " + ", ".join(
                r.name for r in selected[3:]))
        return self._truncate("\n\n".join(parts))

    def _quote(self, selected) -> str:
        quotes = [f"{i + 1}. From {r.name} "
                  f"({r.file_path}:{r.start_line}): \"{(r.snippet or '')[:200]}\""
                  for i, r in enumerate(selected[:3])]
        return self._truncate("\n\n".join(quotes)) if quotes \
            else "No relevant information found."

    def _listing(self, results) -> str:
        return "\n".join(
            f"- {r.name} ({r.file_path}:{r.start_line}) — "
            f"{(r.snippet or '')[:120]}"
            for r in results)

    def _truncate(self, answer: str) -> str:
        cap = self.config.max_response_length
        return answer if len(answer) <= cap else answer[: cap - 3] + "..."

    # -- validation ----------------------------------------------------------

    def _validate(self, answer: str, query: str, selected) -> Dict[str, bool]:
        """Multi-check validation (response_generator.rs:456-505), per-check
        so callers can act on partially-valid answers: well-formedness,
        not-generic, query-keyword overlap, and context grounding (the
        answer must mention a retrieved symbol/file or share keywords
        with the evidence)."""
        contexts = [f"{r.name} {r.file_path} {r.snippet or ''}"
                    for r in selected]
        checks = self._validate_text(answer, query, contexts)
        checks["cites_source"] = any(
            r.name in answer or r.file_path in answer for r in selected)
        return checks

    @staticmethod
    def _validate_text(answer: str, query: str,
                       contexts: Sequence[str]) -> Dict[str, bool]:
        a_lower = answer.lower()
        a_kw = _keywords(answer)
        q_kw = _keywords(query)
        checks = {
            "nonempty": len(answer.strip()) >= 20,
            "not_generic": not any(p in a_lower for p in _GENERIC_PHRASES),
            "query_overlap": not q_kw or bool(q_kw & a_kw),
        }
        if contexts:
            c_kw = _keywords(" ".join(contexts))
            checks["grounded"] = bool(c_kw & a_kw)
        return checks

    @staticmethod
    def _context_relevance(query: str,
                           contexts: Sequence[str]) -> List[float]:
        """Keyword-overlap relevance with an exact-phrase boost
        (response_generator.rs:508-545)."""
        q_kw = _keywords(query)
        q_lower = query.lower()
        scores = []
        for ctx in contexts:
            c_kw = _keywords(ctx)
            kw = len(q_kw & c_kw) / len(q_kw) if q_kw else 0.0
            phrase = 0.5 if q_lower in ctx.lower() else 0.0
            scores.append(min(1.0, kw + phrase))
        return scores

    @staticmethod
    def _finish(resp: GeneratedResponse, t0: float) -> GeneratedResponse:
        resp.processing_time_ms = round((time.perf_counter() - t0) * 1000, 3)
        return resp


__all__ = [
    "GeneratedResponse",
    "GenerationConfig",
    "GenerationMethod",
    "ResponseGenerator",
]

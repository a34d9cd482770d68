"""The port's RAG layer (`codegraph_tpu_torch/rag/`: retriever, ranker,
generator, system, insights; host copies) and `CodeGraph.ask`/`insights`,
held to the JAX package on the CPU.

One snapshot of the slice tests' project (the JAX package's `parser/`),
written by the JAX package with the hash provider at D=768 (hash
embeddings are bitwise equal in both packages), is loaded into both. A
scripted LLM answers from its prompt, so the two packages' answers are
equal exactly when their evidence is. `RAGSystem` skips the LLM once its
latency budget (200 ms by default) has passed; the LLM cases run with a
budget large enough that neither side degrades, and one case with a zero
budget where both do. Tolerances: answers, sources' names and files, query
types, methods and validations equal exactly; source scores (rounded to
four places) and ranker scores within TOL = 1e-4.
"""

import os
import shutil
import types

import pytest

from codegraph_tpu.api import CodeGraph as JCodeGraph
from codegraph_tpu.core.config import CodeGraphConfig as JConfig
from codegraph_tpu.core.types import SearchResult as JResult
from codegraph_tpu.mcp import llm as jllm
from codegraph_tpu.rag import generator as jgen
from codegraph_tpu.rag.query_processor import QueryProcessor as JQP
from codegraph_tpu.rag.system import RAGConfig as JRAGConfig
from codegraph_tpu.rag.system import RAGSystem as JRAG
from codegraph_tpu.rag.retriever import RetrievalMethod as JMethod
from codegraph_tpu_torch.api import CodeGraph as TCodeGraph
from codegraph_tpu_torch.core.config import CodeGraphConfig as TConfig
from codegraph_tpu_torch.core.types import SearchResult as TResult
from codegraph_tpu_torch.mcp import llm as tllm
from codegraph_tpu_torch.rag import generator as tgen
from codegraph_tpu_torch.rag.query_processor import QueryProcessor as TQP
from codegraph_tpu_torch.rag.system import RAGConfig as TRAGConfig
from codegraph_tpu_torch.rag.system import RAGSystem as TRAG
from codegraph_tpu_torch.rag.retriever import RetrievalMethod as TMethod

TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG_BUDGET_MS = 1e9

QUESTIONS = [
    "how does the chunker split a long function?",
    "where is the file watcher polling for changes",
    "explain the python extractor",
    "fix the crash in parse_directory",
    "overview of the parser module structure",
    "find extract_file() usage",
    "lexer tokens for rust",
]


class ScriptedLLM:
    """An LLM that answers from its prompt: the question and the first two
    evidence lines, so equal evidence gives equal answers."""

    def __init__(self):
        self.prompts = []

    def is_available(self):
        return True

    def complete(self, prompt):
        self.prompts.append(prompt)
        lines = prompt.splitlines()
        return "Scripted answer to " + lines[0] + " citing " + " | ".join(lines[2:4])


def _cfg(cls, data_dir, proj):
    cfg = cls()
    cfg.embedding.provider = "hash"
    cfg.embedding.fallbacks = []
    cfg.embedding.dimension = 768
    cfg.data_dir = str(data_dir)
    cfg.project_root = str(proj)
    return cfg


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    root = tmp_path_factory.mktemp("rag")
    proj = root / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "parser"), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))
    JCodeGraph.open(str(proj), config=_cfg(JConfig, root / "data", proj)).index()
    j = JCodeGraph(_cfg(JConfig, root / "data", proj))
    t = TCodeGraph(_cfg(TConfig, root / "data", proj), device="cpu")
    assert len(t.indexer.index) == len(j.indexer.index) > 100
    for q in QUESTIONS[:2]:  # warm both search paths (JAX compiles its scan)
        j.search(q, 10), t.search(q, 10)
    return {"j": j, "t": t}


def _answer_record(ans):
    r = ans.response
    return {"answer": r.answer, "method": r.method.value, "used_llm": r.used_llm,
            "valid": r.valid, "validation": r.validation, "query_type": ans.query_type,
            "degraded": ans.degraded, "stages": sorted(ans.stage_ms),
            "confidence": round(r.confidence, 3),
            "sources": [(s["node_id"], s["name"], s["file"], s["line"], s["snippet"])
                        for s in r.sources]}


def _assert_answers_equal(ja, ta):
    a, b = _answer_record(ja), _answer_record(ta)
    assert b == a
    for x, y in zip(ja.response.sources, ta.response.sources):
        assert abs(x["score"] - y["score"]) <= TOL


@pytest.mark.parametrize("with_llm", [False, True], ids=["no_llm", "scripted_llm"])
@pytest.mark.parametrize("question", QUESTIONS)
def test_rag_system_equals_jax(snap, question, with_llm):
    j, t = snap["j"], snap["t"]
    jl, tl = (ScriptedLLM(), ScriptedLLM()) if with_llm else (None, None)
    jr = JRAG(j.indexer.search, j.indexer.store, llm=jl,
              config=JRAGConfig(latency_budget_ms=BIG_BUDGET_MS))
    tr = TRAG(t.indexer.search, t.indexer.store, llm=tl,
              config=TRAGConfig(latency_budget_ms=BIG_BUDGET_MS))
    ja, ta = jr.process_query(question), tr.process_query(question)
    assert not ja.degraded and not ta.degraded
    _assert_answers_equal(ja, ta)
    if with_llm:
        assert tl.prompts == jl.prompts
        assert ta.response.used_llm == (len(tl.prompts) == 1)


@pytest.mark.parametrize("method", ["semantic", "keyword", "hybrid"])
def test_retrieval_methods_and_popularity_equal(snap, method):
    j, t = snap["j"], snap["t"]
    jr = JRAG(j.indexer.search, j.indexer.store,
              config=JRAGConfig(latency_budget_ms=BIG_BUDGET_MS, method=JMethod(method)))
    tr = TRAG(t.indexer.search, t.indexer.store,
              config=TRAGConfig(latency_budget_ms=BIG_BUDGET_MS, method=TMethod(method)))
    for q in ("chunk plan budget tokens", "watcher poll interval", "chunk plan budget tokens"):
        _assert_answers_equal(jr.process_query(q), tr.process_query(q))
    assert tr.ranker._popularity == jr.ranker._popularity
    jq, tq = JQP().process("lexer scanners"), TQP().process("lexer scanners")
    jres = jr.retriever.retrieve(jq, limit=8, method=JMethod(method))
    tres = tr.retriever.retrieve(tq, limit=8, method=TMethod(method))
    assert [r.node_id for r in tres] == [r.node_id for r in jres]
    for (x, bx), (y, by) in zip(jr.ranker.rank(jres), tr.ranker.rank(tres)):
        assert x.node_id == y.node_id and abs(bx.final - by.final) <= TOL
        assert abs(bx.popularity - by.popularity) <= TOL


def test_both_degrade_over_a_zero_budget(snap):
    j, t = snap["j"], snap["t"]
    jl, tl = ScriptedLLM(), ScriptedLLM()
    ja = JRAG(j.indexer.search, j.indexer.store, llm=jl,
              config=JRAGConfig(latency_budget_ms=0.0)).process_query(QUESTIONS[0])
    ta = TRAG(t.indexer.search, t.indexer.store, llm=tl,
              config=TRAGConfig(latency_budget_ms=0.0)).process_query(QUESTIONS[0])
    assert ja.degraded and ta.degraded
    assert not tl.prompts and not jl.prompts
    _assert_answers_equal(ja, ta)


def test_default_budget_is_the_references():
    assert TRAGConfig().latency_budget_ms == JRAGConfig().latency_budget_ms == 200.0


@pytest.mark.parametrize("question", QUESTIONS[:4])
def test_ask_equals_jax_without_llm(snap, question):
    """CodeGraph.ask with the default configuration (no LLM): the answer
    does not depend on the budget, so the default one is kept."""
    a, b = snap["j"].ask(question), snap["t"].ask(question)
    assert b.keys() == a.keys() == {"answer", "sources", "query_type", "latency_ms"}
    assert b["answer"] == a["answer"] and b["query_type"] == a["query_type"]
    assert [s["node_id"] for s in b["sources"]] == [s["node_id"] for s in a["sources"]]


def test_ask_equals_jax_with_a_scripted_llm(snap, monkeypatch):
    """CodeGraph.ask picks up the configured LLM through create_llm; after a
    warm-up the budget is raised on both sides so that neither degrades."""
    j, t = snap["j"], snap["t"]
    monkeypatch.setattr(jllm, "create_llm", lambda cfg: ScriptedLLM())
    monkeypatch.setattr(tllm, "create_llm", lambda cfg: ScriptedLLM())
    jrag, trag = j._rag, t._rag
    j._rag = t._rag = None
    try:
        j.ask(QUESTIONS[1]), t.ask(QUESTIONS[1])
        assert isinstance(t._rag.generator.llm, ScriptedLLM)
        j._rag.config.latency_budget_ms = t._rag.config.latency_budget_ms = BIG_BUDGET_MS
        scripted = 0
        for q in QUESTIONS:
            a, b = j.ask(q), t.ask(q)
            assert b["answer"] == a["answer"]
            scripted += b["answer"].startswith("Scripted answer")  # not the low-confidence ones
            assert b["sources"] == a["sources"] or all(
                abs(x["score"] - y["score"]) <= TOL and x["node_id"] == y["node_id"]
                for x, y in zip(a["sources"], b["sources"]))
        assert scripted >= 3
    finally:
        j._rag, t._rag = jrag, trag


@pytest.mark.parametrize("topic", ["chunk planning", "file watcher", "python extractor",
                                   "zzz nothing matches qqq"])
def test_insights_equal_jax(snap, topic):
    a, b = snap["j"].insights(topic), snap["t"].insights(topic)
    hits = snap["j"].indexer.search.search_text(topic, 5)
    assert _insights_equal(hits, snap["j"].graph, topic, a, b), _search_report(snap, topic)


def _insights_equal(jax_hits, jax_graph, topic, a, b) -> bool:
    """The port's insights `b` equal the JAX package's `a`; where the port
    ranks the relevant-code hits in another order only among hits whose
    scores tie within TOL, the JAX package's insights are built again from
    its own hits `jax_hits` put in the port's order (the same input) and
    must equal the port's. Near-duplicate chunks tie so: the same import
    line in three files of the fixture, whose chunks differ only in the
    path, score within 1e-7 of each other under some project paths, and
    each package's f32 rounding orders them."""
    if a == b:
        return True
    from codegraph_tpu.rag.insights import InsightsGenerator

    port = next((i["nodes"] for i in b if i["kind"] == "relevant_code"), None)
    by_id = {h.node_id: h for h in jax_hits}
    if port is None or sorted(port) != sorted(by_id):
        return False
    if any(abs(by_id[m].score - by_id[n].score) > TOL
           for m, n in zip([h.node_id for h in jax_hits], port)):
        return False
    ordered = [by_id[n] for n in port]
    again = InsightsGenerator(types.SimpleNamespace(search_text=lambda q, limit: ordered),
                              jax_graph)
    return [i.to_dict() for i in again.generate(topic)] == b


def test_insights_of_tied_hits_in_either_order(snap):
    """A tie between two relevant-code hits, made by giving both packages'
    insights the same five hits with two of equal score: the port's
    insights with the tied pair in the other order equal the JAX package's
    (an exact comparison, which `test_insights_equal_jax` made until now,
    rejects them), and the same swap of two hits that do not tie is
    rejected."""
    import dataclasses

    from codegraph_tpu.rag.insights import InsightsGenerator as JInsights
    from codegraph_tpu_torch.rag.insights import InsightsGenerator as TInsights

    topic = "python extractor"
    hits = [dataclasses.replace(h) for h in snap["j"].indexer.search.search_text(topic, 5)]
    assert len(hits) == 5 and hits[1].score - hits[3].score > TOL
    hits[4].score = hits[3].score  # the last two tie

    def insights(gen_cls, graph, order):
        fixed = types.SimpleNamespace(search_text=lambda q, limit: order)
        return [i.to_dict() for i in gen_cls(fixed, graph).generate(topic)]

    def port_insights(order):
        return insights(TInsights, snap["t"].graph,
                        [TResult(**dataclasses.asdict(hits[i])) for i in order])

    a = insights(JInsights, snap["j"].graph, hits)
    assert port_insights([0, 1, 2, 3, 4]) == a
    tied = port_insights([0, 1, 2, 4, 3])
    assert tied != a and _insights_equal(hits, snap["j"].graph, topic, a, tied)
    untied = port_insights([0, 3, 2, 1, 4])
    assert not _insights_equal(hits, snap["j"].graph, topic, a, untied)


def _search_report(snap, topic, limit=5) -> str:
    """Both sides' hits behind an insight, a mismatch's diagnostic: each
    hit's node row in the snapshot, its score and the score's parts, and
    whether the JAX package's g++ library is loaded in this process (else
    the JAX side ran its Python branches)."""
    import codegraph_tpu.native as jnative

    lines = [f"codegraph_tpu.native.available(): {jnative.available()}"]
    for side in ("j", "t"):
        cg = snap[side]
        rows = cg.indexer.store.node_rows
        lines += [f"{side} row={rows.get(h.node_id, -1)} {h.name} score={h.score:.7f} "
                  f"vector={h.vector_score:.7f} text={h.text_score:.7f} "
                  f"graph_boost={h.graph_boost:.7f}"
                  for h in cg.indexer.search.search_text(topic, limit)]
    return "\n".join(lines)


def _result(cls, name="compute_invoice", score=0.9, snippet="def compute_invoice(items): ..."):
    return cls(node_id=f"id_{name}", chunk_id="c1", score=score, name=name,
               node_type="function", file_path="billing.py", start_line=3, snippet=snippet)


GENERATOR_CASES = {
    "template": ("how is the invoice computed?", [("compute_invoice", 0.9), ("apply_tax", 0.7)],
                 {}),
    "extractive": ("invoice computation paths", [("compute_invoice", 0.9), ("apply_tax", 0.7),
                                                 ("a", 0.6), ("b", 0.5), ("c", 0.45)], {}),
    "quote": ("invoice computation paths", [("compute_invoice", 0.9)],
              {"use_extractive_synthesis": False}),
    "low_confidence": ("how is the invoice computed?", [("compute_invoice", 0.1),
                                                        ("apply_tax", 0.05)], {}),
    "no_results": ("quantum flux capacitor", [], {}),
    "truncated": ("how is the invoice computed?", [("x" * 500, 0.9)],
                  {"max_response_length": 80}),
}


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_generator_ladder_equal_jax(case):
    query, items, gcfg = GENERATOR_CASES[case]
    out = []
    for mod, qp, cls in ((jgen, JQP(), JResult), (tgen, TQP(), TResult)):
        gen = mod.ResponseGenerator(config=mod.GenerationConfig(**gcfg))
        r = gen.generate(qp.process(query), [_result(cls, n, s) for n, s in items])
        out.append((r.answer, r.method.value, r.valid, r.validation, r.confidence, r.sources,
                    r.used_llm))
    assert out[1] == out[0]


@pytest.mark.parametrize("contexts", [
    ["the invoice tax calculation multiplies price by the rate",
     "completely unrelated text about weather patterns"],
    [],
    ["weather only"],
])
def test_generate_from_contexts_equal_jax(contexts):
    a = jgen.ResponseGenerator().generate_from_contexts("invoice tax calculation", contexts)
    b = tgen.ResponseGenerator().generate_from_contexts("invoice tax calculation", contexts)
    assert (b.answer, b.valid, b.confidence, b.sources, b.validation, b.method.value) == (
        a.answer, a.valid, a.confidence, a.sources, a.validation, a.method.value)

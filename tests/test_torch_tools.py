"""The port's tool layer (host copies: `search/reranker.py`,
`graph/queries.py`, `rag/query_processor.py`, `utils/debug_logger.py`,
`mcp/tools.py`), held to the JAX package on the CPU.

One snapshot, written by the JAX package with the hash provider at D=768
(hash embeddings are bitwise equal in both packages), is loaded into both;
every graph tool then answers identically, and `semantic_code_search` with
the default feature reranker gives the same nodes with scores within 1e-5
(f32 sums in another order; a swap of two nodes only where they tie). The
default configuration's encoder path through the same tools is in
`tests/test_torch_slice.py`.
"""

import json
import os
import shutil

import numpy as np
import pytest

from codegraph_tpu.api import CodeGraph as JCodeGraph
from codegraph_tpu.core.config import CodeGraphConfig as JConfig
from codegraph_tpu.core.types import SearchResult as JResult
from codegraph_tpu.mcp.tools import TOOL_SCHEMAS as J_SCHEMAS
from codegraph_tpu.mcp.tools import GraphToolExecutor as JTools
from codegraph_tpu.rag import query_processor as jqp
from codegraph_tpu.search import reranker as jrr
from codegraph_tpu.utils.debug_logger import DebugLogger as JDebug
from codegraph_tpu_torch.api import CodeGraph as TCodeGraph
from codegraph_tpu_torch.core.config import CodeGraphConfig as TConfig
from codegraph_tpu_torch.core.types import SearchResult as TResult
from codegraph_tpu_torch.mcp.tools import TOOL_SCHEMAS as T_SCHEMAS
from codegraph_tpu_torch.mcp.tools import GraphToolExecutor as TTools
from codegraph_tpu_torch.rag import query_processor as tqp
from codegraph_tpu_torch.search import reranker as trr
from codegraph_tpu_torch.utils.debug_logger import DebugLogger as TDebug

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = [
    "compute the transitive dependencies of a node",
    "CSR adjacency from the edge list",
    "which struct stores graph nodes in rust",
    "find_nodes_by_name fuzzy match",
]


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
    root = tmp_path_factory.mktemp("tools")
    proj = root / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "graph"), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))
    JCodeGraph.open(str(proj), config=_cfg(JConfig, root / "data", proj)).index()
    # both packages load the snapshot (a loaded store lists its edges in
    # the snapshot's order, which the tools' `related` lists follow)
    j = JCodeGraph(_cfg(JConfig, root / "data", proj))
    t = TCodeGraph(_cfg(TConfig, root / "data", proj), device="cpu")
    assert len(t.indexer.index) == len(j.indexer.index) > 100
    jt = JTools(j.graph, j.indexer.search,
                jrr.make_reranker_pipeline(j.indexer.provider, j.config.search))
    tt = TTools(t.graph, t.indexer.search,
                trr.make_reranker_pipeline(t.indexer.provider, t.config.search))
    return {"j": j, "t": t, "jt": jt, "tt": tt, "proj": proj}


def test_tool_schemas_equal():
    assert T_SCHEMAS == J_SCHEMAS
    assert len(T_SCHEMAS) == 9


def _node_names(snap, n=6):
    store = snap["j"].indexer.store
    funcs = sorted(n_.name for n_ in store.nodes.values() if n_.node_type.value == "function")
    return funcs[:: max(1, len(funcs) // n)][:n]


def test_graph_tools_equal(snap):
    jt, tt = snap["jt"], snap["tt"]
    calls = [("get_hub_nodes", {"limit": 10}), ("detect_circular_dependencies", {}),
             ("find_complexity_hotspots", {"limit": 10}), ("no_such_tool", {})]
    for name in _node_names(snap) + ["GraphStore", "does_not_exist"]:
        calls += [("get_transitive_dependencies", {"node": name, "max_depth": 3}),
                  ("get_reverse_dependencies", {"node": name}),
                  ("calculate_coupling_metrics", {"node": name}),
                  ("trace_call_chain", {"source": name, "max_depth": 4}),
                  ("find_nodes_by_name", {"name": name[:5], "limit": 5})]
    assert len(calls) > 30
    for tool, params in calls:
        want = jt.execute(tool, params)
        assert tt.execute(tool, params) == want, (tool, params)
    assert tt.stats()["calls"] == jt.stats()["calls"]


def test_graph_queries_equal(snap):
    jq, tq = snap["j"].graph, snap["t"].graph
    assert type(tq).__name__ == "GraphQueries"
    assert tq.top_directories(5) == jq.top_directories(5)
    assert tq.hub_nodes(20) == jq.hub_nodes(20)
    for name in _node_names(snap, 3):
        assert tq.trace_call_chain(name, "store", 5) == jq.trace_call_chain(name, "store", 5)


def _related_key(entries):
    return sorted((e["name"], e["relation"], e["direction"], e["weight"]) for e in entries)


def _assert_results_close(a, b, cap=8):
    """Results position by position (a swap only where scores tie). A hit's
    `related` evidence lists the same neighbours, but in the order of the
    padded adjacency, whose neighbours of equal weight the JAX package orders
    by its native library and the port by the Python loop it copies: so the
    lists are compared as sets, and where one reached the cap (8) only their
    weights, since ties at the cap may keep another neighbour."""
    assert a["count"] == b["count"] > 0
    for x, y in zip(a["results"], b["results"]):
        assert abs(x["score"] - y["score"]) <= TOL
        if x["node_id"] != y["node_id"]:
            continue
        for key in x:
            if key == "related":
                if len(x[key]) < cap and len(y[key]) < cap:
                    assert _related_key(x[key]) == _related_key(y[key])
                assert sorted(e["weight"] for e in x[key]) == sorted(e["weight"] for e in y[key])
            elif isinstance(x[key], float):
                assert abs(x[key] - y[key]) <= TOL, key
            else:
                assert x[key] == y[key], key


@pytest.mark.parametrize("params", [
    {"limit": 10},                                          # default: feature rerank
    {"limit": 5, "rerank": False},
    {"limit": 5, "node_types": ["function"]},               # hard filter
    {"limit": 5, "languages": ["python"], "filter_mode": "soft"},
    {"limit": 5, "model": "other-index"},                   # ignored without a router
])
def test_semantic_code_search_equal(snap, params):
    for query in QUERIES:
        p = {"query": query, **params}
        _assert_results_close(snap["jt"].execute("semantic_code_search", p),
                              snap["tt"].execute("semantic_code_search", p))


def test_tool_cache_and_errors(snap, monkeypatch):
    tt = snap["tt"]
    p = {"query": QUERIES[0], "limit": 3}
    first = tt.execute("semantic_code_search", p)
    hits = tt.cache.stats()
    assert tt.execute("semantic_code_search", p) is first
    assert tt.cache.stats() != hits
    tt.invalidate()
    assert tt.execute("semantic_code_search", p) is not first

    def broken(*a, **k):
        raise ValueError("index mid-swap")

    monkeypatch.setattr(tt.queries, "hub_nodes", broken)
    out = tt.execute("get_hub_nodes", {"limit": 2})
    assert out == {"error": "ValueError: index mid-swap"}
    monkeypatch.undo()
    assert "error" not in tt.execute("get_hub_nodes", {"limit": 2})  # not cached


def _results(cls, n=12, seed=0):
    rng = np.random.default_rng(seed)
    names = ["load_config", "GraphStore", "parse_file", "hub_nodes", "csr_from_edges",
             "transitive_dependencies", "find_nodes_by_name", "SearchCache"]
    out = []
    for i in range(n):
        name = names[i % len(names)] + ("" if i < len(names) else f"_{i}")
        out.append(cls(node_id=f"n{i}", chunk_id=f"c{i}", score=float(rng.random()),
                       name=name, node_type="function",
                       file_path=f"/proj/{['graph', 'search', 'core'][i % 3]}/{name}.py",
                       start_line=i, end_line=i + 3,
                       snippet=f"def {name}(x):\n    return graph store {i}"))
    return out


def _pairs(a, b):
    return [(r.node_id, round(r.score, 6)) for r in a], [(r.node_id, round(r.score, 6)) for r in b]


@pytest.mark.parametrize("query", ["load the graph store config", "csr edges", "x"])
def test_rerankers_equal(query):
    from codegraph_tpu.models.providers import HashProvider as JHash
    from codegraph_tpu_torch.models.providers import HashProvider as THash

    degree = {f"n{i}": i * 3 for i in range(12)}.get
    cases = [
        (jrr.PassthroughReranker(), trr.PassthroughReranker()),
        (jrr.CrossScorerReranker(), trr.CrossScorerReranker()),
        (jrr.FeatureReranker(), trr.FeatureReranker()),
        (jrr.FeatureReranker(degree_fn=degree), trr.FeatureReranker(degree_fn=degree)),
        (jrr.EmbeddingReranker(JHash(64)), trr.EmbeddingReranker(THash(64))),
    ]
    for jr, tr in cases:
        a, b = _pairs(jr.rerank(query, _results(JResult), 5), tr.rerank(query, _results(TResult), 5))
        assert a == b, type(jr).__name__


class _FakeLLM:
    def __init__(self, reply):
        self.reply = reply

    def complete(self, prompt):
        if isinstance(self.reply, Exception):
            raise self.reply
        return self.reply


@pytest.mark.parametrize("reply", ["3, 1, 9, 3", "no digits", RuntimeError("offline")])
def test_llm_reranker_and_pipelines_equal(reply):
    a = jrr.LLMReranker(_FakeLLM(reply)).rerank("q", _results(JResult), 6)
    b = trr.LLMReranker(_FakeLLM(reply)).rerank("q", _results(TResult), 6)
    assert _pairs(a, b)[0] == _pairs(a, b)[1]
    for reranker in ("feature", "embedding", "none"):
        jcfg, tcfg = JConfig().search, TConfig().search
        jcfg.reranker = tcfg.reranker = reranker
        from codegraph_tpu.models.providers import HashProvider as JHash
        from codegraph_tpu_torch.models.providers import HashProvider as THash

        jp = jrr.make_reranker_pipeline(JHash(64), jcfg, llm=_FakeLLM(reply))
        tp = trr.make_reranker_pipeline(THash(64), tcfg, llm=_FakeLLM(reply))
        jp.config.use_llm = tp.config.use_llm = reranker == "none"
        jp.stage3 = jrr.LLMReranker(jp.stage3.llm) if jp.stage3 else None
        tp.stage3 = trr.LLMReranker(tp.stage3.llm) if tp.stage3 else None
        a = jp.rerank("load graph", _results(JResult, n=30))
        b = tp.rerank("load graph", _results(TResult, n=30))
        assert _pairs(a, b)[0] == _pairs(a, b)[1], reranker
        # the inherited stage-2 cap: 20 results whatever rerank_candidates says
        assert len(b) == (10 if tp.stage3 else 20)


def test_cross_encoder_reranker_raises_naming_its_item():
    cfg = TConfig().search
    cfg.reranker = "cross_encoder"
    with pytest.raises(NotImplementedError, match="ROADMAP item 9"):
        trr.make_reranker_pipeline(None, cfg)


@pytest.mark.parametrize("query", [
    "how does the rust parser handle struct definitions",
    "where is load_config() called in graph/store",
    "explain GraphStore::add_edges and HybridSearch",
    "list every function in the search module",
    "",
])
def test_query_processor_equal(snap, query):
    a, b = jqp.QueryProcessor().process(query), tqp.QueryProcessor().process(query)
    assert (a.query_type.value, a.keywords, a.expanded_terms, a.entities, a.expanded_query) == \
        (b.query_type.value, b.keywords, b.expanded_terms, b.entities, b.expanded_query)
    jv = jqp.path_vocabulary(snap["j"].indexer.store.nodes.values())
    tv = tqp.path_vocabulary(snap["t"].indexer.store.nodes.values())
    assert jv == tv
    fa, fb = jqp.infer_soft_filters(query, jv), tqp.infer_soft_filters(query, tv)
    assert (fa is None) == (fb is None)
    if fa is not None:
        assert fa.key() == fb.key()


def test_debug_logger_writes_the_same_records(tmp_path, monkeypatch):
    records = []
    for cls, name in ((JDebug, "j.jsonl"), (TDebug, "t.jsonl")):
        log = cls(str(tmp_path / name))
        assert log.enabled
        log.tool_call("get_hub_nodes", {"limit": 3}, "x" * 900)
        log.reasoning("agent", "because")
        lines = [json.loads(x) for x in (tmp_path / name).read_text().splitlines()]
        records.append([{k: v for k, v in r.items() if k != "ts"} for r in lines])
    assert records[0] == records[1] and len(records[1][0]["result"]) == 500
    monkeypatch.delenv("CODEGRAPH_DEBUG_LOG", raising=False)
    off = TDebug()
    assert not off.enabled
    off.log("tool_call", tool="x")  # writes nothing, raises nothing


def test_tools_with_a_router_raise_naming_its_item(snap):
    with pytest.raises(NotImplementedError, match="ROADMAP item 19"):
        TTools(snap["t"].graph, snap["t"].indexer.search, router=object())

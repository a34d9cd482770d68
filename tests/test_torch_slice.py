"""The port's first slice as a whole, held to the JAX package on the CPU.

A small fixture project (a copy of the JAX package's parser sources) is
indexed by both packages with the hash provider at D=768. Counts, chunk
texts and hash embeddings must be equal (the hash embedder is copied
verbatim, so embeddings are bitwise equal); hybrid search must return the
same top-10 nodes with scores within 1e-5 (the f32 dot products are summed
in another order; a swap of two nodes is allowed only where their scores
tie within that bound). Snapshots written by either package load in the
other. Files are parsed on a thread pool in completion order (in both
packages), so row ids may differ between two runs: rows are compared by
chunk id.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from codegraph_tpu.api import CodeGraph as JCodeGraph
from codegraph_tpu.core.config import CodeGraphConfig as JConfig
from codegraph_tpu.indexer.indexer import ProjectIndexer as JIndexer
from codegraph_tpu_torch.api import CodeGraph as TCodeGraph
from codegraph_tpu_torch.core.config import CodeGraphConfig as TConfig
from codegraph_tpu_torch.graph.csr import adjacency_boost
from codegraph_tpu_torch.indexer.indexer import ProjectIndexer as TIndexer
from codegraph_tpu_torch.search.service import QueryService

from tests.test_torch_topk import assert_topk_equiv

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = [
    "parse a source file into nodes",
    "chunk plan token budget",
    "collect source files with globs",
    "lexer tokens for strings and comments",
]


def _cfg(cls, data_dir):
    cfg = cls()
    cfg.embedding.provider = "hash"
    cfg.embedding.dimension = 768
    cfg.data_dir = str(data_dir)
    return cfg


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    proj = root / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "parser"), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))
    j = JCodeGraph.open(str(proj), config=_cfg(JConfig, root / "jax_data"))
    t = TCodeGraph.open(str(proj), config=_cfg(TConfig, root / "torch_data"), device="cpu")
    return {"root": root, "proj": proj, "j": j, "t": t,
            "js": j.index(), "ts": t.index()}


def test_index_stats_equal(built):
    js, ts = built["js"].to_dict(), built["ts"].to_dict()
    for key in ("files_total", "files_parsed", "nodes", "edges_total", "edges_resolved_exact",
                "edges_resolved_semantic", "edges_unresolved", "edges_external", "chunks",
                "embedded", "analyzer_counters"):
        assert js[key] == ts[key], key
    assert ts["chunks"] > 100 and ts["edges_total"] > 100


def test_chunk_texts_and_hash_embeddings_bitwise(built):
    jstore, tstore = built["j"].indexer.store, built["t"].indexer.store
    jt = {cid: c.text for cid, c in jstore.chunks.items()}
    tt = {cid: c.text for cid, c in tstore.chunks.items()}
    assert jt == tt
    texts = [tt[cid] for cid in sorted(tt)][:200]
    je = built["j"].indexer.provider.embed_texts(texts)
    te = built["t"].indexer.provider.embed_texts(texts)
    assert te.dtype == je.dtype == np.float32
    assert np.array_equal(je, te)


def test_index_rows_equal(built):
    jx, jb = built["j"].indexer.index.arrays()
    tx, tb = built["t"].indexer.index.arrays()
    assert tx.shape == jx.shape
    jrows = built["j"].indexer.store.chunk_rows
    trows = built["t"].indexer.store.chunk_rows
    assert jrows.keys() == trows.keys()
    ids = sorted(jrows)
    jr = np.asarray([jrows[c] for c in ids])
    tr = np.asarray([trows[c] for c in ids])
    np.testing.assert_allclose(tx.numpy()[tr], np.asarray(jx)[jr], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tb.numpy()[tr], np.asarray(jb)[jr])
    assert (tb.numpy()[len(ids):] == np.float32(-1e30)).all()


def _assert_hits_equal(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        # position by position: two nodes may swap only where their scores tie
        assert abs(x.score - y.score) <= TOL
        if x.node_id == y.node_id:
            assert abs(x.vector_score - y.vector_score) <= TOL
            assert abs(x.text_score - y.text_score) <= TOL
            assert abs(x.graph_boost - y.graph_boost) <= TOL


@pytest.mark.parametrize("query", QUERIES)
def test_hybrid_search_top10_matches_jax(built, query):
    a = built["j"].search(query, limit=10)
    b = built["t"].search(query, limit=10)
    _assert_hits_equal(a, b)
    assert [h.node_id for h in a][:3] == [h.node_id for h in b][:3]


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_filtered_search_matches_jax(built, kind):
    """SearchFilters: a hard filter becomes the index's extra_bias mask on
    the device; a soft one only feeds the metadata score."""
    from codegraph_tpu.core.types import SearchFilters as JFilters
    from codegraph_tpu_torch.core.types import SearchFilters as TFilters

    kw = dict(node_types=["function"], soft=kind == "soft")
    a = built["j"].indexer.search.search_text(QUERIES[0], 10, filters=JFilters.make(**kw))
    b = built["t"].indexer.search.search_text(QUERIES[0], 10, filters=TFilters.make(**kw))
    _assert_hits_equal(a, b)
    if kind == "hard":
        assert {h.node_type for h in b} == {"function"}


def test_snapshot_written_by_port_loads_in_jax(built, tmp_path):
    """The port's `index()` saved a snapshot; the JAX indexer loads it and
    answers as the JAX index does."""
    cfg = _cfg(JConfig, built["root"] / "torch_data")
    cfg.project_root = str(built["proj"])
    jl = JIndexer(cfg)
    jl.load(str(built["root"] / "torch_data"))
    assert jl.index.n_live == len(built["t"].indexer.index)
    for q in QUERIES[:2]:
        _assert_hits_equal(jl.search.search_text(q, 10), built["j"].search(q, 10))


def test_snapshot_written_by_jax_loads_in_port(built):
    cfg = _cfg(TConfig, built["root"] / "jax_data")
    cfg.project_root = str(built["proj"])
    tl = TIndexer(cfg, device="cpu")
    tl.load(str(built["root"] / "jax_data"))
    assert tl.index.n_live == len(built["j"].indexer.index)
    assert tl.index.n_rows == built["j"].indexer.index.n_rows
    for q in QUERIES[:2]:
        _assert_hits_equal(tl.search.search_text(q, 10), built["j"].search(q, 10))


def test_reopen_loads_saved_state(built):
    """CodeGraph on an existing data dir loads the snapshot, no re-index."""
    cfg = _cfg(TConfig, built["root"] / "torch_data")
    cfg.project_root = str(built["proj"])
    t2 = TCodeGraph(cfg, device="cpu")
    assert len(t2.indexer.index) == len(built["t"].indexer.index)
    _assert_hits_equal(t2.search(QUERIES[0]), built["t"].search(QUERIES[0]))


def test_update_file_matches_jax(tmp_path):
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "a.py").write_text("def alpha(x):\n    return beta(x) + 1\n\n"
                               "def beta(y):\n    return y * 2\n")
    (proj / "b.py").write_text("from a import alpha\n\nclass Gamma:\n"
                               "    def run(self):\n        return alpha(3)\n")
    j = JCodeGraph.open(str(proj), config=_cfg(JConfig, tmp_path / "j"))
    t = TCodeGraph.open(str(proj), config=_cfg(TConfig, tmp_path / "t"), device="cpu")
    j.index()
    t.index()
    (proj / "a.py").write_text("def alpha(x):\n    return beta(x) + 1\n\n"
                               "def beta(y):\n    return y * 3 - delta(y)\n\n"
                               "def delta(z):\n    return z\n")
    js = j.update_file(str(proj / "a.py"))
    ts = t.update_file(str(proj / "a.py"))
    assert (js.nodes, js.nodes_reused, js.chunks, js.edges_total) == \
        (ts.nodes, ts.nodes_reused, ts.chunks, ts.edges_total)
    assert len(j.indexer.index) == len(t.indexer.index)
    _assert_hits_equal(j.search("delta beta"), t.search("delta beta"))


def test_query_service_batches_match_single_queries(built):
    index = built["t"].indexer.index
    embs = built["t"].indexer.provider.embed_texts([f"{q} {i}" for i, q in
                                                     enumerate(QUERIES * 10)])
    svc = QueryService.auto(index, k=10)
    try:
        futures = [svc.submit(e) for e in embs]
        got = [f.result(timeout=60) for f in futures]
    finally:
        svc.close()
    assert not svc._thread.is_alive()
    assert svc._pool is not None and svc._pool._shutdown
    assert svc.stats.queries == len(embs)
    s_b = np.stack([g[0] for g in got])
    i_b = np.stack([g[1] for g in got])
    s_1, i_1 = index.search(embs, 10)
    x, bias = index.arrays()
    qn = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-6)
    assert_topk_equiv(s_b, i_b, s_1, i_1, qn, x.numpy(), bias.numpy())


@pytest.mark.parametrize("B,K,n,deg", [(1, 30, 50, 4), (3, 17, 200, 32)])
def test_adjacency_boost_matches_jax(rng, B, K, n, deg):
    from codegraph_tpu.graph.csr import adjacency_boost as jboost

    nbr = rng.integers(-1, n, (n, deg)).astype(np.int32)
    nbr[:, -2:] = -1
    nbr[0, 0] = 0  # a self loop must not boost its own row
    wgt = rng.random((n, deg)).astype(np.float32)
    cand = rng.integers(-1, n, (B, K)).astype(np.int32)
    cand[:, 0] = 0
    want = np.asarray(jboost(cand, nbr, wgt))
    got = adjacency_boost(torch.from_numpy(cand), torch.from_numpy(nbr), torch.from_numpy(wgt))
    assert got.shape == (B, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert (got.numpy()[cand < 0] == 0).all()


@pytest.mark.parametrize("override,item", [
    (("embedding", "provider", "ensemble"), "ROADMAP item 6"),
    (("embedding", "provider", "openai"), "ROADMAP item 6"),
    (("index", "kind", "ivf"), "ROADMAP item 10"),
    (("index", "kind", "ivfpq"), "ROADMAP item 11"),
    (("index", "dtype", "int8"), "ROADMAP item 7"),
    (("index", "capacity", 4096), "ROADMAP item 7"),
])
def test_unported_configurations_raise(tmp_path, override, item):
    cfg = _cfg(TConfig, tmp_path / "d")
    section, key, value = override
    setattr(getattr(cfg, section), key, value)
    with pytest.raises(NotImplementedError, match=item):
        TCodeGraph.open(str(tmp_path), config=cfg, device="cpu")

"""The port's slices as a whole, held to the JAX package on the CPU.

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

The same run on the int8 tier (`index.dtype = "int8"`: Int8FlatIndex with
its bf16 rescore copy) holds the banks to the JAX index's (an int8 element
may land one step away, at most 1 in 1,000, where the f32 norms differ in
the last bit; scales within 1e-6 relative; bf16 rows within one bf16
step) and the hybrid results to the same 1e-5.

The IVF tiers (`index.kind = "ivf"` and `"ivfpq"` at the config defaults,
nlist shrunk to the small corpus): the two packages train from different
random centroids, so their indexes differ; each package's snapshot is
loaded by the other and searched there, and the hybrid results must equal
the writer's (same 1e-5, ties as above).
"""

import dataclasses
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


# -- a width that is not a multiple of 8: embedding.dimension = 100 ----------


@pytest.fixture(scope="module")
def built_d100(tmp_path_factory):
    """The slice with the hash provider at embedding.dimension = 100 (a
    width users configure; its f32 rows are 400 bytes, its bf16 rows 200,
    its int8 rows 100: none of TMA's multiples of 16 but the first), over
    the same project as `built`."""
    root = tmp_path_factory.mktemp("slice_d100")
    proj = root / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "parser"), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))

    def cfg(cls, data):
        c = _cfg(cls, root / data)
        c.embedding.dimension = 100
        return c

    j = JCodeGraph.open(str(proj), config=cfg(JConfig, "jax_data"))
    t = TCodeGraph.open(str(proj), config=cfg(TConfig, "torch_data"), device="cpu")
    return {"j": j, "t": t, "js": j.index(), "ts": t.index()}


def test_d100_index_rows_equal(built_d100):
    """Both packages index the same chunks into 100-wide rows, equal
    within 1e-6 by chunk id."""
    assert built_d100["js"].to_dict()["chunks"] == built_d100["ts"].to_dict()["chunks"] > 100
    jx, jb = built_d100["j"].indexer.index.arrays()
    tx, tb = built_d100["t"].indexer.index.arrays()
    assert tx.shape == jx.shape and tx.shape[1] == 100
    jrows = built_d100["j"].indexer.store.chunk_rows
    trows = built_d100["t"].indexer.store.chunk_rows
    ids = sorted(jrows)
    np.testing.assert_allclose(tx.numpy()[[trows[c] for c in ids]],
                               np.asarray(jx)[[jrows[c] for c in ids]], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tb.numpy()[[trows[c] for c in ids]],
                                  np.asarray(jb)[[jrows[c] for c in ids]])


@pytest.mark.parametrize("query", QUERIES)
def test_d100_hybrid_search_top10_matches_jax(built_d100, query):
    """index -> search at D = 100: the same top-10 as JAX within 1e-5."""
    _assert_hits_equal(built_d100["j"].search(query, limit=10),
                       built_d100["t"].search(query, limit=10))


def test_d100_query_service_batches_match_single_queries(built_d100):
    """QueryService's batches (K2 on a card) equal single queries (K1) at
    D = 100."""
    index = built_d100["t"].indexer.index
    embs = built_d100["t"].indexer.provider.embed_texts([f"{q} {i}" for i, q in
                                                         enumerate(QUERIES * 10)])
    svc = QueryService.auto(index, k=10)
    try:
        got = [f.result(timeout=60) for f in [svc.submit(e) for e in embs]]
    finally:
        svc.close()
    s_1, i_1 = index.search(embs, 10)
    x, bias = index.arrays()
    qn = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-6)
    assert_topk_equiv(np.stack([g[0] for g in got]), np.stack([g[1] for g in got]), s_1, i_1,
                      qn, x.numpy(), bias.numpy())


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


def _cross_encoder_reranker(cg):
    from codegraph_tpu_torch.models.cross_encoder import CrossEncoder
    from codegraph_tpu_torch.search.reranker import make_reranker_pipeline

    cg.config.search.reranker = "cross_encoder"
    pipeline = make_reranker_pipeline(cg.indexer.provider, cg.config.search,
                                      device=cg.indexer.device)
    assert isinstance(pipeline.cross_encoder, CrossEncoder)
    assert pipeline.cross_encoder.device == cg.indexer.device


def _tools_with_a_router(cg):
    from codegraph_tpu_torch.mcp.tools import GraphToolExecutor
    from codegraph_tpu_torch.search.router import IndexRouter

    router = IndexRouter()
    router.register("default", cg.indexer.provider, cg.indexer.search)
    tools = GraphToolExecutor(cg.graph, cg.indexer.search, router=router)
    assert tools.router is router


@pytest.mark.parametrize("build,item", [
    (_cross_encoder_reranker, "ROADMAP item 9"),
    (_tools_with_a_router, "ROADMAP item 19"),
])
def test_unported_configurations_raise(tmp_path, build, item):
    """The two configurations that raised NotImplementedError naming their
    ROADMAP item until this slice ported them (the cross-encoder reranker,
    item 9; the tools' router, item 19) now build on the CPU and raise
    nothing; `tests/test_torch_cross_encoder.py` and
    `tests/test_torch_router.py` hold them to the JAX package."""
    cg = TCodeGraph.open(str(tmp_path), config=_cfg(TConfig, tmp_path / "d"), device="cpu")
    build(cg)


@pytest.mark.parametrize("override,tier", [
    (("index", "dtype", "int8"), ("Int8FlatIndex", "int8")),
    (("index", "capacity", 4096), ("FlatIndex", "float32")),  # planned: small corpus, exact f32
])
def test_configurations_of_this_slice_open(tmp_path, override, tier):
    """The two configurations that raised before the int8 slice: both
    packages build the same tier and answer alike."""
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "a.py").write_text("def alpha(x):\n    return beta(x) + 1\n\n"
                               "def beta(y):\n    return y * 2\n")
    (proj / "b.py").write_text("from a import alpha\n\nclass Gamma:\n"
                               "    def run(self):\n        return alpha(3)\n")
    section, key, value = override
    graphs = []
    for cls, gcls, kw in ((JConfig, JCodeGraph, {}), (TConfig, TCodeGraph, {"device": "cpu"})):
        cfg = _cfg(cls, tmp_path / cls.__module__.split(".")[0])
        setattr(getattr(cfg, section), key, value)
        graphs.append(gcls.open(str(proj), config=cfg, **kw))
    j, t = graphs
    assert (type(t.indexer.index).__name__, t.config.index.dtype) == tier
    assert type(j.indexer.index).__name__ == tier[0] and j.config.index.dtype == tier[1]
    j.index()
    t.index()
    assert len(j.indexer.index) == len(t.indexer.index) > 0
    _assert_hits_equal(j.search("alpha beta"), t.search("alpha beta"))


# ---------------------------------------------------------------------------
# the same slice on the int8 tier (Int8FlatIndex with its bf16 rescore copy)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built_int8(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice_int8")
    proj = root / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "parser"), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))
    jcfg, tcfg = _cfg(JConfig, root / "jax_data"), _cfg(TConfig, root / "torch_data")
    jcfg.index.dtype = tcfg.index.dtype = "int8"
    j = JCodeGraph.open(str(proj), config=jcfg)
    t = TCodeGraph.open(str(proj), config=tcfg, device="cpu")
    return {"root": root, "proj": proj, "j": j, "t": t, "js": j.index(), "ts": t.index()}


def _int8_cfg(cls, data_dir, proj):
    cfg = _cfg(cls, data_dir)
    cfg.index.dtype = "int8"
    cfg.project_root = str(proj)
    return cfg


def test_int8_index_banks_match_jax(built_int8):
    """The int8 rows, scales and rescore rows, compared by chunk id."""
    jq, js_, jr, jb = (np.asarray(a, np.float32) for a in built_int8["j"].indexer.index.arrays())
    tq, ts_, tr, tb = built_int8["t"].indexer.index.arrays()
    assert tq.shape == jq.shape and tq.dtype == torch.int8 and tr.dtype == torch.bfloat16
    jrows = built_int8["j"].indexer.store.chunk_rows
    trows = built_int8["t"].indexer.store.chunk_rows
    assert jrows.keys() == trows.keys()
    ids = sorted(jrows)
    jr_ = np.asarray([jrows[c] for c in ids])
    tr_ = np.asarray([trows[c] for c in ids])
    dq = np.abs(tq.numpy()[tr_].astype(np.float32) - jq[jr_])
    assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3  # a last-bit norm difference
    np.testing.assert_allclose(ts_.numpy()[tr_], js_[jr_], rtol=1e-6, atol=0)
    np.testing.assert_allclose(tr.float().numpy()[tr_], jr[jr_], rtol=2.0**-7, atol=0)
    np.testing.assert_array_equal(tb.numpy()[tr_], jb[jr_])


@pytest.mark.parametrize("query", QUERIES)
def test_int8_hybrid_search_top10_matches_jax(built_int8, query):
    a = built_int8["j"].search(query, limit=10)
    b = built_int8["t"].search(query, limit=10)
    _assert_hits_equal(a, b)
    assert [h.node_id for h in a][:3] == [h.node_id for h in b][:3]


def test_int8_snapshot_written_by_port_loads_in_jax(built_int8):
    root = built_int8["root"]
    jl = JIndexer(_int8_cfg(JConfig, root / "torch_data", built_int8["proj"]))
    jl.load(str(root / "torch_data"))
    assert jl.index.n_live == len(built_int8["t"].indexer.index)
    assert np.asarray(jl.index.arrays()[0]).dtype == np.int8
    for q in QUERIES[:2]:
        _assert_hits_equal(jl.search.search_text(q, 10), built_int8["t"].search(q, 10))


def test_int8_snapshot_written_by_jax_loads_in_port(built_int8):
    root = built_int8["root"]
    tl = TIndexer(_int8_cfg(TConfig, root / "jax_data", built_int8["proj"]), device="cpu")
    tl.load(str(root / "jax_data"))
    jidx = built_int8["j"].indexer.index
    assert (tl.index.n_live, tl.index.n_rows) == (len(jidx), jidx.n_rows)
    np.testing.assert_array_equal(tl.index.arrays()[0].numpy(), np.asarray(jidx.arrays()[0]))
    for q in QUERIES[:2]:
        _assert_hits_equal(tl.search.search_text(q, 10), built_int8["j"].search(q, 10))


def test_int8_query_service_batches_match_single_queries(built_int8):
    """64-query flushes (a K6 batch on the card) against single (K5)
    searches of the same index."""
    index = built_int8["t"].indexer.index
    embs = built_int8["t"].indexer.provider.embed_texts(
        [f"{q} {i}" for i, q in enumerate(QUERIES * 10)])
    svc = QueryService.auto(index, k=10)
    try:
        got = [f.result(timeout=60) for f in [svc.submit(e) for e in embs]]
    finally:
        svc.close()
    assert svc.stats.queries == len(embs)
    s_b = np.stack([g[0] for g in got])
    i_b = np.stack([g[1] for g in got])
    singles = [index.search(e[None, :], 10) for e in embs]
    s_1 = np.concatenate([s for s, _ in singles])
    i_1 = np.concatenate([i for _, i in singles])
    _, _, r, _ = index.arrays()
    qn = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-6)
    # the final scores are the bf16 rescore rows' dot products: they judge ties
    assert_topk_equiv(s_b, i_b, s_1, i_1, qn, r.float().numpy(), np.zeros(r.shape[0], np.float32))


# ---------------------------------------------------------------------------
# the IVF tiers: index.kind = "ivf" and "ivfpq" through the entry points
# ---------------------------------------------------------------------------


def _kind_cfg(cls, data_dir, kind, proj=None):
    cfg = _cfg(cls, data_dir)
    cfg.index.kind = kind
    if proj is not None:
        cfg.project_root = str(proj)
    return cfg


@pytest.fixture(scope="module", params=["ivf", "ivfpq"])
def built_ivf(request, tmp_path_factory):
    kind = request.param
    root = tmp_path_factory.mktemp(f"slice_{kind}")
    proj = root / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "parser"), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))
    j = JCodeGraph.open(str(proj), config=_kind_cfg(JConfig, root / "jax_data", kind))
    t = TCodeGraph.open(str(proj), config=_kind_cfg(TConfig, root / "torch_data", kind),
                        device="cpu")
    return {"kind": kind, "root": root, "proj": proj, "j": j, "t": t,
            "js": j.index(), "ts": t.index()}


def test_ivf_tiers_index_like_jax(built_ivf):
    """The same counts, the same shrunk nlist, and every chunk row live in
    both packages' IVF index."""
    j, t = built_ivf["j"].indexer.index, built_ivf["t"].indexer.index
    assert type(t).__name__ == type(j).__name__ == {"ivf": "IVFIndex",
                                                     "ivfpq": "IVFPQIndex"}[built_ivf["kind"]]
    assert built_ivf["ts"].chunks == built_ivf["js"].chunks > 100
    assert (t.nlist, t.nprobe, t.n_rows) == (j.nlist, j.nprobe, j.n_rows)
    assert t.nlist == built_ivf["ts"].chunks // 8 and len(t._fill) == 4096
    assert len(t) == len(j) == t.n_rows
    if built_ivf["kind"] == "ivfpq":
        assert t.m == j.m == 96 and t.refine == j.refine == "int8"
        assert len(t._raw_chunks) and t._books.shape == np.asarray(j._books).shape


def _loaded(cls, built, writer):
    """An indexer of package `cls` loading `writer`'s snapshot."""
    src = "jax_data" if writer == "j" else "torch_data"
    cfg = _kind_cfg(TConfig if cls is TIndexer else JConfig, built["root"] / src,
                    built["kind"], built["proj"])
    idx = cls(cfg, device="cpu") if cls is TIndexer else cls(cfg)
    idx.load(str(built["root"] / src))
    return idx


@pytest.mark.parametrize("query", QUERIES)
def test_ivf_snapshot_written_by_jax_searched_in_port(built_ivf, query):
    tl = _loaded(TIndexer, built_ivf, "j")
    assert tl.index.n_live == len(built_ivf["j"].indexer.index)
    _assert_hits_equal(tl.search.search_text(query, 10), built_ivf["j"].search(query, limit=10))


@pytest.mark.parametrize("query", QUERIES[:2])
def test_ivf_snapshot_written_by_port_searched_in_jax(built_ivf, query):
    jl = _loaded(JIndexer, built_ivf, "t")
    assert jl.index.n_live == len(built_ivf["t"].indexer.index)
    _assert_hits_equal(jl.search.search_text(query, 10), built_ivf["t"].search(query, limit=10))


def test_ivf_filtered_search_on_jax_snapshot(built_ivf):
    """A hard filter on identical state: IVF-PQ applies it as extra_bias
    after an over-fetch; IVF (no extra_bias) through the host fallback."""
    from codegraph_tpu.core.types import SearchFilters as JFilters
    from codegraph_tpu_torch.core.types import SearchFilters as TFilters

    tl = _loaded(TIndexer, built_ivf, "j")
    a = built_ivf["j"].indexer.search.search_text(QUERIES[0], 10,
                                                  filters=JFilters.make(node_types=["class"]))
    b = tl.search.search_text(QUERIES[0], 10, filters=TFilters.make(node_types=["class"]))
    _assert_hits_equal(a, b)
    assert {h.node_type for h in b} == {"class"}


def test_ivf_query_service_batches_match_single_queries(built_ivf):
    index = built_ivf["t"].indexer.index
    embs = built_ivf["t"].indexer.provider.embed_texts(
        [f"{q} {i}" for i, q in enumerate(QUERIES * 8)])
    svc = QueryService.auto(index, k=10)
    try:
        got = [f.result(timeout=60) for f in [svc.submit(e) for e in embs]]
    finally:
        svc.close()
    assert svc.stats.queries == len(embs)
    singles = [index.search(e[None, :], 10) for e in embs]
    for (s_b, i_b), (s_1, i_1) in zip(got, singles):
        # scores position by position; ids may differ only among ties with
        # the last place
        np.testing.assert_allclose(s_b, s_1[0], rtol=0, atol=TOL)
        above = s_1[0] > s_1[0][-1] + TOL
        assert set(i_b[above]) == set(i_1[0][above])


def test_snapshot_of_another_kind_raises_in_port_and_is_skipped_in_jax(built, tmp_path):
    """The port refuses a snapshot whose index kind differs from the
    configured one; the JAX package skips it and serves an empty index."""
    from codegraph_tpu_torch.core.errors import SnapshotError

    data = built["root"] / "torch_data"  # a flat snapshot
    for kind in ("ivf", "ivfpq"):
        with pytest.raises(SnapshotError, match="'flat'"):
            TCodeGraph(_kind_cfg(TConfig, data, kind, built["proj"]), device="cpu")
    int8 = _cfg(TConfig, data)
    int8.project_root = str(built["proj"])
    int8.index.dtype = "int8"
    with pytest.raises(SnapshotError, match="'int8'"):
        TCodeGraph(int8, device="cpu")
    j = JCodeGraph(_kind_cfg(JConfig, data, "ivfpq", built["proj"]))
    assert len(j.indexer.store.nodes) > 0 and len(j.indexer.index) == 0


def test_open_with_capacity_planned_to_ivfpq_matches_jax(tmp_path):
    """100M x 768 rows: the int8 matrix is over the CPU's 8 GiB budget, so
    both packages plan IVF-PQ (nlist 32,768, m=96, host int8 refine); a tiny
    project then shrinks nlist, and _fill keeps its 32,768 entries."""
    proj = tmp_path / "proj"
    proj.mkdir()
    for n in range(3):
        (proj / f"m{n}.py").write_text("".join(
            f"def f{n}_{i}(x):\n    return x * {i} + {n}\n\n" for i in range(40)))
    graphs = []
    for cls, gcls, kw in ((JConfig, JCodeGraph, {}), (TConfig, TCodeGraph, {"device": "cpu"})):
        cfg = _cfg(cls, tmp_path / cls.__module__.split(".")[0])
        cfg.index.capacity = 100_000_000
        graphs.append(gcls.open(str(proj), config=cfg, **kw))
    j, t = graphs
    assert dataclasses.asdict(t.config.index) == dataclasses.asdict(j.config.index)
    assert (t.config.index.kind, t.config.index.nlist, t.config.index.pq_m) == ("ivfpq", 32768, 96)
    j.index()
    t.index()
    ti = t.indexer.index
    assert type(ti).__name__ == "IVFPQIndex" and len(ti._fill) == 32768
    assert ti.nlist == j.indexer.index.nlist and len(ti) == len(j.indexer.index) > 100
    hits = t.search("f1_7 returns x times", limit=5)
    assert len(hits) == 5
    jcfg = _kind_cfg(JConfig, tmp_path / "codegraph_tpu_torch", "ivfpq", proj)
    jcfg.index.nlist, jcfg.index.nprobe = t.config.index.nlist, t.config.index.nprobe
    jl = JIndexer(jcfg)
    jl.load(str(tmp_path / "codegraph_tpu_torch"))
    _assert_hits_equal(jl.search.search_text("f1_7 returns x times", 5), hits)


# -- the default configuration: the ensemble provider (r3 encoder + hash) ----

# Embeddings of the default provider agree within the encoder's bf16
# tolerance (tests/test_torch_encoder.py, BF16_TOL at the shipped width);
# scores, cosines and hits are held to the same bound
ENC_TOL = 2e-3
NEAR_MISS = '''"""Callers whose targets are spelled unlike their definitions."""


def load_configuration(path):
    return read_configuration_file(path)


def read_configuration_file(path):
    with open(path) as f:
        return f.read()


def parse_source_files(paths):
    return [read_configuration_file(p) for p in paths]


def build_dependency_graph(files):
    return {f: [] for f in files}


def main(path):
    cfg = load_config(path)
    files = parse_sources([path])
    graph = build_dep_graph(files)
    text = read_config_file(path)
    return cfg, graph, text, parse_source_file(path), dependency_graph(files)
'''
DEFAULT_QUERIES = ["read the configuration file", "csr adjacency boost of candidates",
                   "filter search results by language"]


def _default_cfg(cls, data_dir):
    cfg = cls()
    cfg.data_dir = str(data_dir)
    cfg.embedding.batch_size = 16  # JAX pads every bucket group to batch_size rows
    return cfg


def _record_semantic(resolver_cls, log):
    """Wrap resolver_cls._semantic_match: log each target it was given and
    the node id it resolved to (None where it stayed unresolved)."""
    inner = resolver_cls._semantic_match

    def wrapped(self, pending, symbols):
        targets = [e.dst for e in pending]
        n = inner(self, pending, symbols)
        for t, e in zip(targets, pending):
            log[t] = e.dst if e.resolved else None
        return n
    return wrapped


@pytest.fixture(scope="module")
def built_default(tmp_path_factory):
    from codegraph_tpu.indexer.resolve import EdgeResolver as JResolver
    from codegraph_tpu_torch.indexer.resolve import EdgeResolver as TResolver

    root = tmp_path_factory.mktemp("slice_default")
    proj = root / "proj"
    proj.mkdir()
    for rel in ("graph/csr.py", "search/filters.py"):
        shutil.copy(os.path.join(REPO, "codegraph_tpu", rel), proj / os.path.basename(rel))
    (proj / "near.py").write_text(NEAR_MISS)
    semantic = {"j": {}, "t": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JResolver, "_semantic_match", _record_semantic(JResolver, semantic["j"]))
        mp.setattr(TResolver, "_semantic_match", _record_semantic(TResolver, semantic["t"]))
        j = JCodeGraph.open(str(proj), config=_default_cfg(JConfig, root / "jax_data"))
        t = TCodeGraph.open(str(proj), config=_default_cfg(TConfig, root / "torch_data"),
                            device="cpu")
        js, ts = j.index(), t.index()
    return {"root": root, "proj": proj, "j": j, "t": t, "js": js, "ts": ts,
            "semantic": semantic}


def test_default_config_chunks_equal(built_default):
    j, t = built_default["j"], built_default["t"]
    assert [p.name for p in t.indexer.provider.providers] == ["ensemble", "hash"]
    jt = {cid: c.text for cid, c in j.indexer.store.chunks.items()}
    tt = {cid: c.text for cid, c in t.indexer.store.chunks.items()}
    assert jt == tt and len(tt) > 50
    js, ts = built_default["js"].to_dict(), built_default["ts"].to_dict()
    for key in ("files_total", "nodes", "edges_total", "edges_external", "chunks", "embedded"):
        assert js[key] == ts[key], key
    # every text went through the encoder, none through the hash member
    ens, hsh = t.indexer.provider.providers
    assert hsh.metrics.texts == 0 and ens.encoder.metrics.texts >= ts["chunks"]


def test_default_config_embeddings_per_chunk(built_default):
    jx, _ = built_default["j"].indexer.index.arrays()
    tx, _ = built_default["t"].indexer.index.arrays()
    jrows = built_default["j"].indexer.store.chunk_rows
    trows = built_default["t"].indexer.store.chunk_rows
    assert jrows.keys() == trows.keys()
    ids = sorted(jrows)
    jr = np.asarray(jx)[[jrows[c] for c in ids]]
    tr = tx.numpy()[[trows[c] for c in ids]]
    np.testing.assert_allclose(tr, jr, rtol=0, atol=ENC_TOL)
    # the hash half (the last 256 dimensions, weight sqrt(0.5)) is copied code:
    # it differs only through the row norm the flat index divides by
    np.testing.assert_allclose(tr[:, 512:], jr[:, 512:], rtol=1e-3, atol=1e-6)


def test_default_config_edges_equal_except_near_threshold(built_default):
    """Semantic edges: a target may resolve differently only where its best
    candidate's cosine lies within ENC_TOL of the 0.75 threshold, or ties
    with the other package's choice within ENC_TOL (cosines on the JAX
    package's embeddings)."""
    from codegraph_tpu.indexer.resolve import SEMANTIC_THRESHOLD

    j, t = built_default["j"], built_default["t"]
    sj, st = built_default["semantic"]["j"], built_default["semantic"]["t"]
    assert sj.keys() == st.keys() and sum(v is not None for v in st.values()) >= 2
    near, moved = 0, set()
    names = {n.id: n.name for n in j.indexer.store.nodes.values()}
    for target in sorted(sj):
        if sj[target] == st[target]:
            continue
        near += 1
        moved |= {sj[target], st[target]} - {None}
        cands = [names[v] for v in (sj[target], st[target]) if v is not None]
        e = j.indexer.provider.embed_texts([target] + cands)
        cos = [float(e[0] @ row) for row in e[1:]]
        at_threshold = any(abs(c - SEMANTIC_THRESHOLD) <= ENC_TOL for c in cos)
        tied = len(cos) == 2 and abs(cos[0] - cos[1]) <= ENC_TOL
        assert at_threshold or tied, (target, sj[target], st[target], cos)
    print(f"semantic targets resolved differently near the threshold: {near} of {len(sj)}")
    # every other edge is the same in both packages
    je = {(e.src, e.dst, e.edge_type) for e in j.indexer.store.edges if e.dst not in moved}
    te = {(e.src, e.dst, e.edge_type) for e in t.indexer.store.edges if e.dst not in moved}
    assert je == te and len(te) > 50


def _assert_hits_close(a, b, tol=ENC_TOL):
    """Hybrid hits position by position; two nodes may swap only where their
    scores tie within tol (the query embeddings differ within the encoder's
    bf16 tolerance)."""
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert abs(x.score - y.score) <= tol


@pytest.mark.parametrize("query", DEFAULT_QUERIES)
def test_default_config_search_matches_jax(built_default, query):
    _assert_hits_close(built_default["j"].search(query, 10), built_default["t"].search(query, 10))


def test_default_config_tools_on_one_snapshot(built_default):
    """The JAX package's snapshot loaded into the port: semantic_code_search
    with the default feature reranker and a few graph tools answer as the
    JAX package's do on the same snapshot."""
    from codegraph_tpu.mcp.tools import GraphToolExecutor as JTools
    from codegraph_tpu.search.reranker import make_reranker_pipeline as jrerank
    from codegraph_tpu_torch.mcp.tools import GraphToolExecutor as TTools
    from codegraph_tpu_torch.search.reranker import make_reranker_pipeline as trerank

    j = built_default["j"]
    cfg = _default_cfg(TConfig, built_default["root"] / "jax_data")
    cfg.project_root = str(built_default["proj"])
    t = TCodeGraph(cfg, device="cpu")
    assert len(t.indexer.index) == len(j.indexer.index)
    jt = JTools(j.graph, j.indexer.search, jrerank(j.indexer.provider, j.config.search))
    tt = TTools(t.graph, t.indexer.search, trerank(t.indexer.provider, t.config.search))
    for query in DEFAULT_QUERIES:
        a = jt.execute("semantic_code_search", {"query": query, "limit": 5})
        b = tt.execute("semantic_code_search", {"query": query, "limit": 5})
        assert a["count"] == b["count"] > 0
        for x, y in zip(a["results"], b["results"]):
            assert abs(x["score"] - y["score"]) <= ENC_TOL
            if x["node_id"] == y["node_id"]:
                assert x.keys() == y.keys()
    for tool, params in (("get_hub_nodes", {"limit": 5}),
                         ("find_nodes_by_name", {"name": "load_configuration"}),
                         ("get_transitive_dependencies", {"node": "main", "max_depth": 2}),
                         ("detect_circular_dependencies", {})):
        assert tt.execute(tool, params) == jt.execute(tool, params), tool

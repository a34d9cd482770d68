"""The port's host library (`csrc/cghost.cpp`, `codegraph_tpu_torch/native.py`),
held on the CPU to its plain versions and to the JAX package.

Three functions, each called where the JAX package calls its own g++
library (`native/cghost.cpp`): the padded adjacency of the graph boost
(`CSRGraph.padded_adjacency`, symmetric), the trigram preselection of edge
resolution (`EdgeResolver._semantic_match`) and BM25 scoring from 2,000
docs (`BM25Index.search`). Against the plain versions (the Python loops
beside each caller) ids must be equal but where scores tie, and scores
equal (BM25: within 1e-5 relative, f32 against f64). Against the JAX
package's library, which is the same source built by the same compiler,
they must be equal outright; where that library does not load in this
process, the JAX package runs its Python branch, and the port is held to
that branch as to its plain version. The library is built with g++ into
`codegraph_tpu_torch/_build/` at first use; a failed build raises.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import codegraph_tpu.native as jnative
from codegraph_tpu.core.types import EDGE_TYPE_CODES as J_CODES
from codegraph_tpu.graph import csr as jcsr
from codegraph_tpu.indexer import resolve as jresolve
from codegraph_tpu.search.bm25 import BM25Index as JBM25
from codegraph_tpu_torch import native
from codegraph_tpu_torch.core.types import EDGE_TYPE_CODES as T_CODES
from codegraph_tpu_torch.graph import csr as tcsr
from codegraph_tpu_torch.ops import cuda_build
from codegraph_tpu_torch.search.bm25 import BM25Index as TBM25
from codegraph_tpu_torch.search.bm25 import tokenize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BM25_RTOL = 1e-5


def _jax_native():
    """True where the JAX package's library loads in this process. Each
    process of a fresh tree builds it with `make -B` when it first needs it,
    and GNU ld writes the file in place: a process that loads it while
    another is writing it fails, and the JAX package then runs its Python
    branches for the rest of that process. Such a load is retried here once
    the file can be loaded."""
    for _ in range(60):
        if jnative.available():
            return True
        if not os.path.exists(jnative._SO_PATH):
            return False  # no build: the JAX package runs its Python branches
        jnative._load_failed = False
        time.sleep(1.0)
    return False


# ---------------------------------------------------------------------------
# padded adjacency
# ---------------------------------------------------------------------------


def _graph(codes, seed):
    """300 nodes; three hubs of 40-60 neighbours whose weights come from
    {0.5, 1, 2} (ties at every cut), self loops, duplicate edges of another
    weight, and edges of a type that does not boost."""
    rng = np.random.default_rng(seed)
    boost = [codes[k] for k in codes if codes[k] in tcsr.BOOST_EDGE_CODES]
    other = [c for c in codes.values() if c not in tcsr.BOOST_EDGE_CODES]
    n, src, dst, et, w = 300, [], [], [], []
    for hub, deg in ((0, 60), (1, 40), (2, 45)):
        nb = rng.choice(np.arange(3, n), deg, replace=False)
        out = rng.random(deg) < 0.6
        src += list(np.where(out, hub, nb))
        dst += list(np.where(out, nb, hub))
        et += list(rng.choice(boost, deg))
        w += list(rng.choice([0.5, 1.0, 2.0], deg))
    m = 900
    src += list(rng.integers(0, n, m))
    dst += list(rng.integers(0, n, m))
    et += list(rng.choice(boost + other, m))
    w += list(rng.choice([0.25, 0.5, 1.0, 1.5], m))
    for r in range(0, n, 17):  # self loops
        src.append(r), dst.append(r), et.append(boost[0]), w.append(1.0)
    dup = rng.integers(0, len(src), 60)  # the same edge again, another weight
    src += [src[i] for i in dup]
    dst += [dst[i] for i in dup]
    et += [et[i] for i in dup]
    w += list(rng.choice([0.5, 3.0], 60))
    return (n, np.array(src), np.array(dst), np.array(et, np.int16),
            np.array(w, np.float32))


def _row_truth(csr, row):
    """id -> (weight, edge type, direction) of a row's heaviest boost edge
    to each neighbour, outgoing first on a tie."""
    truth = {}
    for ptr, ids, ets, ws, d in ((csr.indptr, csr.indices, csr.etype, csr.weight, 0),
                                 (csr.r_indptr, csr.r_indices, csr.r_etype, csr.r_weight, 1)):
        for j in range(int(ptr[row]), int(ptr[row + 1])):
            if int(ets[j]) in tcsr.BOOST_EDGE_CODES:
                i = int(ids[j])
                if i not in truth or float(ws[j]) > truth[i][0]:
                    truth[i] = (float(ws[j]), int(ets[j]), d)
    return truth


def _assert_tables_equal_but_ties(csr, a, b, max_deg):
    """Two [n, max_deg] tables: the same weights row by row; where a row
    differs, each side keeps distinct neighbours, each with the weight, edge
    type and direction of its heaviest boost edge in the CSR, and the
    heaviest min(degree, max_deg) weights (so the kept ids differ only
    among those tied at a full row's cut)."""
    assert np.array_equal(a[1], b[1])
    differ = np.zeros(a[0].shape[0], bool)
    for ta, tb in zip(a, b):
        differ |= (ta != tb).any(1)
    for row in np.nonzero(differ)[0]:
        truth = _row_truth(csr, row)
        heaviest = sorted((w for w, _, _ in truth.values()), reverse=True)[:max_deg]
        for nbr, wgt, et, dirn in (a, b):
            kept = [(int(i), (float(w), int(e), int(d)))
                    for i, w, e, d in zip(nbr[row], wgt[row], et[row], dirn[row]) if i >= 0]
            assert len({i for i, _ in kept}) == len(kept) == len(heaviest), row
            assert all(truth.get(i) == v for i, v in kept), row
            assert sorted((v[0] for _, v in kept), reverse=True) == heaviest, row


@pytest.mark.parametrize("max_deg", [4, 32, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_padded_adjacency_matches_plain_and_jax(seed, max_deg):
    tg = tcsr.build_csr(*_graph(T_CODES, seed))
    jg = jcsr.build_csr(*_graph(J_CODES, seed))
    before = native.calls["padded_adjacency"]
    got = tg.padded_adjacency(max_deg=max_deg)
    assert native.calls["padded_adjacency"] == before + 1
    plain = tg.padded_adjacency_plain(max_deg=max_deg)
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype and a.shape == b.shape == (300, max_deg)
    _assert_tables_equal_but_ties(tg, got, plain, max_deg)
    cut = (got[0] >= 0).sum(1) == max_deg
    assert cut[:3].all() or max_deg == 64  # the hubs are cut at 4 and 32
    assert any(got[0][r][got[0][r] >= 0].tolist().count(r) for r in range(0, 300, 17))
    jax_native = _jax_native()  # before the JAX call, which falls back if it fails
    want = jg.padded_adjacency(max_deg=max_deg)
    if jax_native:  # the same source and compiler: the same table
        for a, b in zip(want, got):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    else:  # the JAX Python branch is the port's plain version
        for a, b in zip(want, plain):
            assert np.array_equal(a, b)
        _assert_tables_equal_but_ties(tg, got, want, max_deg)


def test_padded_adjacency_one_directional_stays_plain():
    """symmetric=False is the Python loop in both packages."""
    tg = tcsr.build_csr(*_graph(T_CODES, 2))
    jg = jcsr.build_csr(*_graph(J_CODES, 2))
    before = native.calls["padded_adjacency"]
    got = tg.padded_adjacency(max_deg=8, symmetric=False)
    assert native.calls["padded_adjacency"] == before
    for a, b in zip(jg.padded_adjacency(max_deg=8, symmetric=False), got):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# trigram preselection
# ---------------------------------------------------------------------------

WORDS = ["parse", "file", "load", "config", "render", "page", "compute", "checksum",
         "total", "graph", "node", "edge", "index", "search", "query", "token"]


def _names(seed, n, mixed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        parts = rng.choice(WORDS, rng.integers(1, 4))
        name = "_".join(parts)
        if mixed and rng.random() < 0.3:
            name = "".join(p.capitalize() for p in parts)
        if mixed and rng.random() < 0.05:
            name += "é"
        out.append(name)
    return list(dict.fromkeys(out))


def _preselect_cases():
    tied = [f"parse_file{c}" for c in "abcdefghij"]  # ten ties for eight places
    return {
        "mixed": (_names(3, 40, True) + ["zzzz", "ab"], _names(4, 2000, True) + tied + ["ab"]),
        "lower": (_names(5, 30, False) + ["parse_file", "qqqq"], _names(6, 1500, False) + tied),
    }


def _assert_preselect_equal_but_ties(a, b, full):
    """Two (idx, score) tables: the same scores; the same ids but where a
    full row's ids tie at its cut, where each id must truly score the cut
    (`full`: every candidate's score, row by row)."""
    (ia, sa), (ib, sb) = a, b
    assert np.array_equal(sa, sb) and np.array_equal(ia >= 0, ib >= 0)
    for row in range(ia.shape[0]):
        va = ia[row] >= 0
        if set(ia[row][va]) == set(ib[row][va]):
            continue
        assert va.all(), row
        cut = sa[row][-1]
        keep = sa[row] > cut
        assert set(ia[row][keep]) == set(ib[row][keep]), row
        for ids in (ia[row][~keep], ib[row][~keep]):
            assert all(full[row][int(j)] == cut for j in ids), row


@pytest.mark.parametrize("case", ["mixed", "lower"])
def test_trigram_preselect_matches_plain_and_jax(case):
    targets, symbols = _preselect_cases()[case]
    before = native.calls["trigram_preselect"]
    got = native.trigram_preselect_native(targets, symbols, 0.3, 8)
    assert native.calls["trigram_preselect"] == before + 1
    plain = native.trigram_preselect_plain(targets, symbols, 0.3, 8)
    ia, sa = native.trigram_preselect_plain(targets, symbols, 0.0, len(symbols))
    full = [dict(zip(ia[r].tolist(), sa[r].tolist())) for r in range(len(targets))]
    _assert_preselect_equal_but_ties(got, plain, full)
    nothing = targets.index("zzzz" if case == "mixed" else "qqqq")
    assert (got[0][nothing] == -1).all() and (got[1][nothing] == 0).all()
    if case == "lower":  # ten tied for eight places
        row = targets.index("parse_file")
        assert (got[0][row] >= 0).all() and len(set(got[1][row])) == 1
    if _jax_native():
        want = jnative.trigram_preselect_native(targets, symbols, 0.3, 8)
        assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
    elif case == "lower":  # the JAX Python branch (lower-case ASCII: the same trigrams)
        for ti, t in enumerate(targets):
            cands = [s for s in symbols if jresolve._trigram_jaccard(t, s) >= 0.3]
            best = sorted(cands, key=lambda s: -jresolve._trigram_jaccard(t, s))[:8]
            assert len(best) == int((got[0][ti] >= 0).sum())
            assert sorted(round(jresolve._trigram_jaccard(t, s), 6) for s in best) == \
                sorted(round(float(x), 6) for x in got[1][ti][got[0][ti] >= 0])


def test_trigram_preselect_of_nothing_calls_nothing():
    before = native.calls["trigram_preselect"]
    idx, score = native.trigram_preselect_native(["a"], [], 0.3, 8)
    assert idx.shape == (1, 8) and (idx == -1).all() and (score == 0).all()
    assert native.calls["trigram_preselect"] == before


def _resolver_input(types):
    CodeEdge, CodeNode, EdgeType, Language, Location, NodeType = types

    def mk(name):
        return CodeNode.make("p", name, NodeType.FUNCTION, Language.PYTHON,
                             Location("a.py", 1, 2))

    names = ["compute_checksum", "compute_total", "render_page", "parse_file",
             "parse_files_fast", "load_config", "load_configs", "graph_index"]
    nodes = [mk(n) for n in names]
    targets = ["compute_checksums", "render_pages", "parse_filez", "load_confi",
               "graph_indexes", "zzzz", "compute_checksumz"]
    edges = [CodeEdge(nodes[i % len(nodes)].id, t, EdgeType.CALLS, resolved=False)
             for i, t in enumerate(targets)]
    return edges, nodes


def test_resolver_semantic_edges_equal_jax():
    """EdgeResolver with the hash provider: the same semantic edges and
    targets in both packages (the port's preselection is the library's)."""
    from codegraph_tpu.core import types as jt
    from codegraph_tpu.models.providers import HashProvider as JHash
    from codegraph_tpu_torch.core import types as tt
    from codegraph_tpu_torch.indexer.resolve import EdgeResolver as TResolver
    from codegraph_tpu_torch.models.providers import HashProvider as THash

    out = []
    for mod, resolver_cls, hash_cls in ((jt, jresolve.EdgeResolver, JHash),
                                        (tt, TResolver, THash)):
        edges, nodes = _resolver_input((mod.CodeEdge, mod.CodeNode, mod.EdgeType,
                                        mod.Language, mod.Location, mod.NodeType))
        resolver = resolver_cls(provider=hash_cls(64), semantic_threshold=0.5)
        _, n_exact, n_sem, n_ext = resolver.resolve(edges, nodes)
        out.append((n_exact, n_sem, n_ext, [(e.dst, e.resolved) for e in edges]))
    before = native.calls["trigram_preselect"]
    assert out[1] == out[0]
    assert out[1][1] >= 2
    edges, nodes = _resolver_input((tt.CodeEdge, tt.CodeNode, tt.EdgeType, tt.Language,
                                    tt.Location, tt.NodeType))
    TResolver(provider=THash(64), semantic_threshold=0.5).resolve(edges, nodes)
    assert native.calls["trigram_preselect"] == before + 1


# ---------------------------------------------------------------------------
# BM25
# ---------------------------------------------------------------------------


def _docs(n, seed=0):
    rng = np.random.default_rng(seed)
    vocab = [f"{a}{b}" for a in ("parse", "load", "graph", "index", "query", "token", "edge")
             for b in ("", "r", "s", "ing", "ed", "_file", "Node", "_map")]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    return [" ".join(rng.choice(vocab, int(rng.integers(3, 40)), p=p)) for _ in range(n)]


def _assert_ranked_equal_but_ties(index, query, a, b, rtol=BM25_RTOL):
    """Two [(doc, score)] lists, highest first: scores position by position
    within rtol; a doc on one side only must score the cut within rtol by
    its own score, recomputed in f64 from `index`."""
    assert len(a) == len(b) > 0
    sa = np.array([s for _, s in a])
    sb = np.array([s for _, s in b])
    np.testing.assert_allclose(sb, sa, rtol=rtol)
    terms = [t for t in set(tokenize(query)) if t in index.postings]
    avg = index.total_len / index.n_docs
    cut = sa[-1]
    for d in dict(a).keys() ^ dict(b).keys():
        own = sum(index._idf(t) * tf * (index.k1 + 1)
                  / (tf + index.k1 * (1 - index.b + index.b * index.doc_len[d] / avg))
                  for t in terms for tf in [index.postings[t].get(d, 0)] if tf)
        assert abs(own - cut) <= rtol * abs(cut), d


@pytest.mark.parametrize("query", ["parse file", "graphNode index_map", "tokens edge loaded"])
def test_bm25_from_2000_docs_matches_plain_and_jax(query):
    docs = _docs(2500)
    ti, ji = TBM25(), JBM25()
    for i, d in enumerate(docs):
        ti.add(i, d), ji.add(i, d)
    ti.remove(7), ji.remove(7)
    assert ti.n_docs >= TBM25.NATIVE_THRESHOLD == JBM25.NATIVE_THRESHOLD
    before = native.calls["bm25_score"]
    got = ti.search(query, limit=200)
    assert native.calls["bm25_score"] == before + 1
    assert len(got) == 200 and 7 not in dict(got)
    terms = [t for t in set(tokenize(query)) if t in ti.postings]
    plain = ti._search_plain(terms, ti.total_len / ti.n_docs, 200)
    _assert_ranked_equal_but_ties(ti, query, got, plain)
    jax_native = _jax_native()  # before the JAX call, which falls back if it fails
    want = ji.search(query, limit=200)
    if jax_native:
        assert [d for d, _ in want] == [d for d, _ in got]
        assert [s for _, s in want] == [s for _, s in got]
    else:
        _assert_ranked_equal_but_ties(ti, query, got, want)


def test_bm25_below_2000_docs_stays_plain():
    docs = _docs(1999, seed=1)
    ti, ji = TBM25(), JBM25()
    for i, d in enumerate(docs):
        ti.add(i, d), ji.add(i, d)
    before = native.calls["bm25_score"]
    got = ti.search("parse file", limit=50)
    assert native.calls["bm25_score"] == before
    assert got == ji.search("parse file", limit=50)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compiler", ["missing", "failing"])
def test_failed_host_build_raises(tmp_path, monkeypatch, compiler):
    """No compiler, or one that fails: the call raises with the compiler's
    word and nothing falls back."""
    cxx = str(tmp_path / "no-such-g++") if compiler == "missing" else "false"
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(native, "_lib", None)
    before = dict(native.calls)
    match = "not found" if compiler == "missing" else "false failed to build cghost.cpp"
    with pytest.raises(RuntimeError, match=match):
        native.trigram_preselect_native(["parse_file"], ["parse_files"], 0.3, 8)
    with pytest.raises(RuntimeError, match=match):
        tcsr.build_csr(*_graph(T_CODES, 0)).padded_adjacency(max_deg=4)
    assert native.calls == before and native._lib is None
    assert not list(tmp_path.glob("build/*.so"))


BUILD_ONE = r"""
import ctypes, pathlib, sys, time
sys.path.insert(0, sys.argv[1])
from codegraph_tpu_torch.ops import cuda_build
cuda_build.BUILD_DIR = pathlib.Path(sys.argv[2])
while time.time() < float(sys.argv[3]):
    time.sleep(0.005)
so = cuda_build.build_host("cghost")
lib = ctypes.CDLL(str(so))
lib.cg_abi_version.restype = ctypes.c_int64
print(so, lib.cg_abi_version())
"""


def test_two_processes_building_at_once_load_one_library(tmp_path):
    """Two processes that find no library both compile; each puts a whole
    library in place with os.replace, and both load the same path."""
    build = tmp_path / "build"
    start = str(time.time() + 1.5)
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONE, REPO, str(build), start],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = [o[0].split() for o in outs]
    assert lines[0] == lines[1] and lines[0][1] == "2"
    assert [p.name for p in build.glob("*.so")] == [os.path.basename(lines[0][0])]
    assert not list(build.glob("*.tmp"))

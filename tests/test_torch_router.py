"""The port's `IndexRouter` (`codegraph_tpu_torch/search/router.py`, a host
copy) and the tools' `model` parameter routed through it, held to the JAX
package on the CPU.

Routing (names, widths, the default, the errors) must be equal exactly.
Searches run on the same seeded numpy rows in both packages' FlatIndex;
scores within TOL = 1e-5 (f32 sums in another order), ids equal except
where the scores tie within TOL. The tool layer runs on one snapshot
written by the JAX package with the hash provider (hash embeddings are
bitwise equal in both packages) and loaded into both.
"""

import os
import shutil

import numpy as np
import pytest

from codegraph_tpu.api import CodeGraph as JCodeGraph
from codegraph_tpu.core.config import CodeGraphConfig as JConfig
from codegraph_tpu.index.flat import FlatIndex as JFlat
from codegraph_tpu.mcp.tools import GraphToolExecutor as JTools
from codegraph_tpu.models.providers import HashProvider as JHash
from codegraph_tpu.search.router import IndexRouter as JRouter
from codegraph_tpu.search.router import RoutingError as JRoutingError
from codegraph_tpu_torch.api import CodeGraph as TCodeGraph
from codegraph_tpu_torch.core.config import CodeGraphConfig as TConfig
from codegraph_tpu_torch.index.flat import FlatIndex as TFlat
from codegraph_tpu_torch.mcp.tools import GraphToolExecutor as TTools
from codegraph_tpu_torch.models.providers import HashProvider as THash
from codegraph_tpu_torch.search.router import IndexRouter as TRouter
from codegraph_tpu_torch.search.router import RoutingError as TRoutingError

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _routers(widths=(32, 64), default="large"):
    """Both packages' routers over backends of the same seeded rows."""
    routers = []
    for Router, Hash, flat in ((JRouter, JHash, lambda d: JFlat(d, tile_n=128, backend="xla")),
                               (TRouter, THash, lambda d: TFlat(d, device="cpu"))):
        r = Router()
        for name, dim, seed in zip(("small", "large", "other"), widths, (0, 1, 2)):
            idx = flat(dim)
            idx.add(np.random.default_rng(seed).standard_normal((64, dim)).astype(np.float32))
            r.register(name, Hash(dim), idx, default=(name == default))
        routers.append(r)
    return routers


def _assert_hits_equal(a, b):
    (js, ji), (ts, ti) = a, b
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL)
    for b_, k_ in zip(*np.nonzero(np.atleast_2d(ti) != np.atleast_2d(ji))):
        row = np.atleast_2d(js)[b_]
        near = [abs(row[n] - row[k_]) for n in (k_ - 1, k_ + 1) if 0 <= n < row.size]
        assert min(near) <= TOL


@pytest.mark.parametrize("widths,default", [((32, 64), "large"), ((32, 64), None),
                                            ((32, 32, 64), "other"), ((48, 48), "small")])
def test_resolution_equals_jax(widths, default):
    j, t = _routers(widths, default)
    assert t.names() == j.names() and t.dimensions() == j.dimensions()
    for model, dim in [(None, None), ("small", None), ("large", 32), (None, 32), (None, 48),
                       (None, 64), ("nope", None), (None, 128)]:
        try:
            want = j.resolve(model=model, dimension=dim)
        except JRoutingError as exc:
            with pytest.raises(TRoutingError) as got:
                t.resolve(model=model, dimension=dim)
            assert str(got.value) == str(exc)
            continue
        assert t.resolve(model=model, dimension=dim) == want
    st_j, st_t = j.stats(), t.stats()
    assert st_t == st_j


def test_routing_error_is_a_key_error():
    assert issubclass(TRoutingError, KeyError)
    with pytest.raises(TRoutingError, match="no backends registered"):
        TRouter().resolve()


@pytest.mark.parametrize("model", [None, "small", "large"])
def test_searches_land_on_their_backend(model):
    j, t = _routers()
    rng = np.random.default_rng(9)
    for dim in (32, 64):
        if model is not None and dict(small=32, large=64)[model] != dim:
            continue
        q = rng.standard_normal(dim).astype(np.float32)
        _assert_hits_equal(j.search_vector(q, k=5, model=model), t.search_vector(q, k=5, model=model))
    _assert_hits_equal(j.search_text("hello router", limit=4, model=model),
                       t.search_text("hello router", limit=4, model=model))


def _cfg(cls, data_dir, proj, dim):
    cfg = cls()
    cfg.embedding.provider = "hash"
    cfg.embedding.fallbacks = []
    cfg.embedding.dimension = dim
    cfg.data_dir = str(data_dir)
    cfg.project_root = str(proj)
    return cfg


@pytest.fixture(scope="module")
def routed(tmp_path_factory):
    """Two backends of different widths over one project (the JAX package's
    `search/`), one snapshot each written by the JAX package, loaded into
    both packages' routers and tool executors."""
    root = tmp_path_factory.mktemp("router")
    proj = root / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "search"), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = {}
    for name, dim in (("hash768", 768), ("hash256", 256)):
        JCodeGraph.open(str(proj), config=_cfg(JConfig, root / name, proj, dim)).index()
        out[name] = (JCodeGraph(_cfg(JConfig, root / name, proj, dim)),
                     TCodeGraph(_cfg(TConfig, root / name, proj, dim), device="cpu"))
    jr, tr = JRouter(), TRouter()
    for name, (j, t) in out.items():
        jr.register(name, j.indexer.provider, j.indexer.search, default=name == "hash768")
        tr.register(name, t.indexer.provider, t.indexer.search, default=name == "hash768")
    j0, t0 = out["hash768"]
    jt = JTools(j0.graph, j0.indexer.search, router=jr)
    tt = TTools(t0.graph, t0.indexer.search, router=tr)
    return {"cg": out, "jr": jr, "tr": tr, "jt": jt, "tt": tt}


@pytest.mark.parametrize("model", ["hash768", "hash256", None])
@pytest.mark.parametrize("query", ["rerank the candidates", "bm25 scoring of documents"])
def test_tool_model_parameter_routes_like_jax(routed, model, query):
    params = {"query": query, "limit": 6}
    if model:
        params["model"] = model
    a, b = routed["jt"].execute("semantic_code_search", params), \
        routed["tt"].execute("semantic_code_search", params)
    assert "error" not in b and a["count"] == b["count"] > 0
    for x, y in zip(a["results"], b["results"]):
        assert abs(x["score"] - y["score"]) <= TOL
    assert [r["node_id"] for r in a["results"]] == [r["node_id"] for r in b["results"]]
    # the routed backend answers as its own tools do without a router
    t = routed["cg"][model or "hash768"][1]
    own = TTools(t.graph, t.indexer.search).execute(
        "semantic_code_search", {"query": query, "limit": 6})
    assert own == b


def test_tool_unknown_model_is_a_structured_error(routed):
    a = routed["jt"].execute("semantic_code_search", {"query": "x", "model": "nope"})
    b = routed["tt"].execute("semantic_code_search", {"query": "x", "model": "nope"})
    assert b == a and b["error"].startswith("RoutingError")


def test_router_search_vector_by_width(routed):
    """A raw vector routes by its width to the backend that serves it."""
    rng = np.random.default_rng(3)
    for dim in (768, 256):
        q = rng.standard_normal(dim).astype(np.float32)
        _assert_hits_equal(routed["jr"].search_vector(q, 5), routed["tr"].search_vector(q, 5))
        want = routed["cg"]["hash768" if dim == 768 else "hash256"][1].indexer.index.search(
            q[None, :], 5)
        np.testing.assert_array_equal(routed["tr"].search_vector(q, 5)[1], want[1])

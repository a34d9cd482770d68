"""The port's cross-encoder (`codegraph_tpu_torch/models/cross_encoder.py`)
and the `reranker="cross_encoder"` pipeline, held to the JAX package on the
CPU.

Tolerances. Pair framing is compared exactly. The forward runs in bf16 with
f32 sums in both packages, and the CLS vector is not normalized: it is the
final layer norm's output rounded to bf16, |x| < 4 here, where one bf16 step
is 2^-7 to 2^-6. The two packages round some elements a step apart (XLA
keeps excess precision inside its fusions, ROADMAP queue 3), so CLS vectors
are held to CE_TOL = 6.25e-2 (four steps at |x| < 4) with a mean gap of at
most CE_MEAN_TOL, and the scores (cls @ head.w + head.b, |score| < 20) to
CE_TOL too: the shipped checkpoint measured 3.1e-2 (CLS, mean 1.2e-3) and
2.4e-2 (scores) against the golden file, the small random models of these
tests up to 3.1e-2 (CLS, mean 3.8e-3) and 9.8e-3 (scores) over six seeds
(on this file's CPU, with the CPU path of the port). The blended rerank score is min-max
normalized, so a pair of candidates may swap only where their blended
scores lie within `_blend_tol` (0.3 x 3 x CE_TOL over the candidates'
score span) of each other.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.core.config import CodeGraphConfig as JConfig
from codegraph_tpu.core.types import SearchResult as JResult
from codegraph_tpu.models import cross_encoder as jce_mod
from codegraph_tpu.models.bpe import make_tokenizer as jmake_tokenizer
from codegraph_tpu.models.cross_encoder import CrossEncoder as JCE
from codegraph_tpu.models.cross_encoder import save_cross_encoder as jsave
from codegraph_tpu.models.encoder import EncoderConfig as JEncCfg
from codegraph_tpu.models.providers import HashProvider as JHash
from codegraph_tpu.models.tokenizer import ByteTokenizer as JByte
from codegraph_tpu.search import reranker as jrr
from codegraph_tpu_torch.core.config import CodeGraphConfig as TConfig
from codegraph_tpu_torch.core.types import SearchResult as TResult
from codegraph_tpu_torch.models import cross_encoder as tce_mod
from codegraph_tpu_torch.models.bpe import make_tokenizer as tmake_tokenizer
from codegraph_tpu_torch.models.cross_encoder import CrossEncoder as TCE
from codegraph_tpu_torch.models.cross_encoder import cross_encoder_params_from_jax
from codegraph_tpu_torch.models.cross_encoder import save_cross_encoder as tsave
from codegraph_tpu_torch.models.encoder import EncoderConfig as TEncCfg
from codegraph_tpu_torch.models.providers import HashProvider as THash
from codegraph_tpu_torch.models.tokenizer import ByteTokenizer as TByte
from codegraph_tpu_torch.search import reranker as trr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "cross_encoder_r3.npz")
BPE = os.path.join(REPO, "checkpoints", "bpe_code_16k.json")
GOLDEN = os.path.join(REPO, "tests", "data", "cross_encoder_r3_golden.npz")

CE_TOL = 6.25e-2
CE_MEAN_TOL = 5e-3

QUERY_CASES = [
    "parse the file",
    "how does HybridSearch combine bm25 with the graph boost " * 4,  # > Q_LEN tokens
    "",
]
DOCS = [
    "def parse_file(p):\n    return SourceParser().parse(p)",
    "class HttpServer:\n    pass",
    "",
    open(os.path.join(REPO, "codegraph_tpu", "search", "hybrid.py"), encoding="utf-8").read()[:3000],
    "ünïcödé → bytes",
]


def _tokenizers(kind, max_len):
    if kind == "byte":
        return JByte(max_len=max_len), TByte(max_len=max_len)
    return jmake_tokenizer(BPE, max_len=max_len), tmake_tokenizer(BPE, max_len=max_len)


def _random_pair(seed, tokenizers=("byte", 64), hidden=64, n_layers=2, max_len=64, **variant):
    """A JAX scorer and the port's over the same weights: a numpy tree from
    `seed` (norm scales and biases away from 1 and 0) carried across."""
    jtok, ttok = _tokenizers(*tokenizers)
    j = JCE(hidden=hidden, n_layers=n_layers, max_len=max_len, seed=seed, tokenizer=jtok)
    j.cfg = JEncCfg(vocab_size=j.cfg.vocab_size, hidden=hidden, n_layers=n_layers,
                    n_heads=j.cfg.n_heads, max_len=max_len, pooling="cls", **variant)
    from codegraph_tpu.models.encoder import init_encoder_params

    shapes = jax.tree_util.tree_map(lambda a: a.shape,
                                    init_encoder_params(jax.random.PRNGKey(0), j.cfg))
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = str(path[-1].key)
        if name.endswith("_scale"):
            return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name.startswith("b") or name.endswith("_bias"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))
    head = {"w": (rng.standard_normal(hidden) / np.sqrt(hidden)).astype(np.float32),
            "b": np.float32(0.25)}
    j.params, j.head = tree, head
    tcfg = TEncCfg(vocab_size=j.cfg.vocab_size, hidden=hidden, n_layers=n_layers,
                   n_heads=j.cfg.n_heads, max_len=max_len, pooling="cls", **variant)
    t = TCE.from_params(*cross_encoder_params_from_jax(tree, head), cfg=tcfg, tokenizer=ttok,
                        device="cpu")
    return j, t


def _results(cls, n, seed):
    """n SearchResult-likes of in-repo text with seeded retrieval scores."""
    rng = np.random.default_rng(seed)
    src = open(os.path.join(REPO, "codegraph_tpu", "search", "reranker.py"),
               encoding="utf-8").read()
    scores = rng.random(n)
    return [cls(node_id=f"n{i}", chunk_id="", score=float(scores[i]), name=f"symbol_{i}",
                snippet=src[400 * i: 400 * i + 240]) for i in range(n)]


def _blend_tol(ce_scores) -> float:
    span = float(np.max(ce_scores) - np.min(ce_scores))
    return 0.3 * 3 * CE_TOL / span if span > 0 else 0.0


def _assert_same_order(a, b, tol):
    """Two reranked lists: the same scores within tol position by position,
    and a differing id only where its neighbour's blended score ties."""
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert abs(x.score - y.score) <= tol
        if x.node_id != y.node_id:
            near = [abs(b[n].score - y.score) for n in (i - 1, i + 1) if 0 <= n < len(b)]
            assert min(near) <= tol, (i, x.node_id, y.node_id)


@pytest.mark.parametrize("kind", ["byte", "bpe"])
@pytest.mark.parametrize("max_len", [64, 16, 256])
def test_pair_framing_equals_jax(kind, max_len):
    jtok, ttok = _tokenizers(kind, max_len)
    j = JCE(hidden=32, n_layers=1, max_len=max_len, tokenizer=jtok)
    t = TCE(hidden=32, n_layers=1, max_len=max_len, tokenizer=ttok, device="cpu")
    for q in QUERY_CASES:
        ji, jm = j._encode_pairs(q, DOCS)
        ti, tm = t._encode_pairs(q, DOCS)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, jm)
        assert ti.dtype == np.int32 and tm.dtype == np.bool_


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_model_scores_and_rerank_equal_jax(seed):
    j, t = _random_pair(seed)
    q = "parse the file"
    want = j.score_pairs(q, DOCS)
    got = t.score_pairs(q, DOCS)
    assert got.dtype == np.float32 and got.shape == (len(DOCS),)
    np.testing.assert_allclose(got, want, rtol=0, atol=CE_TOL)
    ids, mask = j._encode_pairs(q, DOCS)
    jcls = np.asarray(j._encode(j.params, jnp.asarray(ids), jnp.asarray(mask), j.cfg,
                                normalize=False))
    tcls = t.cls_vectors(ids, mask).numpy()
    assert np.abs(tcls - jcls).max() <= CE_TOL and np.abs(tcls - jcls).mean() <= CE_MEAN_TOL
    assert t.as_scorer()(q, DOCS[0]) == pytest.approx(float(got[0]), abs=1e-4)
    assert t.score_pairs(q, []).shape == (0,)

    a, b = _results(JResult, 12, seed), _results(TResult, 12, seed)
    texts = [f"{r.name} {r.snippet}" for r in a]
    tol = _blend_tol(j.score_pairs(q, texts))
    ja, tb = j.rerank_batch(q, a, k=8), t.rerank_batch(q, b, k=8)
    assert len(tb) == 8
    _assert_same_order(ja, tb, tol)


@pytest.mark.parametrize("variant", [
    dict(norm_style="post", act="gelu_exact", mlp_ratio=2, eps=1e-5),
    dict(attn_bias=True),
    dict(),
])
def test_arch_variants_restored_from_meta(tmp_path, variant):
    """A checkpoint with non-default architecture knobs reloads onto the
    same graph in both packages, whichever package saved it."""
    j, t = _random_pair(3, hidden=32, n_layers=2, **variant)
    if variant.get("attn_bias"):
        rng = np.random.default_rng(4)
        j.params["layers"]["b_qkv"] = (0.1 * rng.standard_normal((2, 96))).astype(np.float32)
        j.params["layers"]["b_o"] = (0.1 * rng.standard_normal((2, 32))).astype(np.float32)
        t.params["layers.b_qkv"] = torch.from_numpy(j.params["layers"]["b_qkv"])
        t.params["layers.b_o"] = torch.from_numpy(j.params["layers"]["b_o"])
    docs = DOCS[:2]
    want = j.score_pairs("parse the file", docs)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsave(jpath, j)
    tsave(tpath, t)
    for path in (jpath, tpath):
        back = TCE(checkpoint=path, device="cpu")  # ctor defaults must not leak in
        for key in ("norm_style", "act", "mlp_ratio", "eps", "attn_bias", "n_heads", "hidden"):
            assert getattr(back.cfg, key) == getattr(j.cfg, key), key
        np.testing.assert_allclose(back.score_pairs("parse the file", docs), want, atol=CE_TOL)
        jback = JCE(checkpoint=path)
        assert jback.cfg.norm_style == j.cfg.norm_style and jback.cfg.act == j.cfg.act
        np.testing.assert_allclose(jback.score_pairs("parse the file", docs), want, atol=1e-4)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


@pytest.fixture(scope="module")
def shipped():
    return TCE(checkpoint=CKPT, device="cpu")


def test_shipped_checkpoint_architecture(shipped):
    cfg = shipped.cfg
    assert (cfg.hidden, cfg.n_layers, cfg.n_heads, cfg.max_len, cfg.pooling) == (
        384, 4, 8, 256, "cls")
    assert cfg.vocab_size == 16644 and type(shipped.tokenizer).__name__ == "BPETokenizer"
    assert tce_mod.default_cross_encoder_checkpoint() == CKPT


def test_shipped_checkpoint_against_the_golden_file(shipped, golden):
    assert golden["ids"].shape == (16, 256)
    for r, (q, d) in enumerate(zip(golden["queries"], golden["docs"])):
        ids, mask = shipped._encode_pairs(str(q), [str(d)])
        np.testing.assert_array_equal(ids[0], golden["ids"][r])
        np.testing.assert_array_equal(mask[0], golden["mask"][r])
    cls = shipped.cls_vectors(golden["ids"], golden["mask"]).numpy()
    gap = np.abs(cls - golden["cls"])
    assert gap.max() <= CE_TOL and gap.mean() <= CE_MEAN_TOL
    scores = shipped.score_framed(golden["ids"], golden["mask"]).numpy()
    np.testing.assert_allclose(scores, golden["scores"], rtol=0, atol=CE_TOL)


def test_reranker_pipeline_equals_jax(monkeypatch):
    """make_reranker_pipeline(reranker="cross_encoder") in both packages on
    the same candidates: stage 1 re-embeds with the hash provider (bitwise
    equal), stage 2 is the shipped checkpoint; the same order, but where the
    blended scores tie."""
    jcfg, tcfg = JConfig().search, TConfig().search
    jcfg.reranker = tcfg.reranker = "cross_encoder"
    jp = jrr.make_reranker_pipeline(JHash(64), jcfg)
    tp = trr.make_reranker_pipeline(THash(64), tcfg, device="cpu")
    assert isinstance(tp.cross_encoder, TCE) and isinstance(tp.stage1, trr.EmbeddingReranker)
    assert tp.cross_encoder.device.type == "cpu"
    q = "rerank the candidates with the cross-encoder"
    a, b = _results(JResult, 24, 7), _results(TResult, 24, 7)
    stage1 = jrr.EmbeddingReranker(JHash(64)).rerank(q, _results(JResult, 24, 7), 20)
    tol = _blend_tol(jp.cross_encoder.score_pairs(q, [f"{r.name} {r.snippet}" for r in stage1]))
    ja, tb = jp.rerank(q, a), tp.rerank(q, b)
    assert len(tb) == len(ja) == 20
    _assert_same_order(ja, tb, tol)


@pytest.mark.parametrize("case", ["missing_default_checkpoint", "nonexistent_path",
                                  "cuda_without_gpu"])
def test_port_raises_where_jax_falls_back(monkeypatch, case):
    """The three refusals: the JAX package builds a random-init scorer for
    the first two; the port raises."""
    if case == "missing_default_checkpoint":
        monkeypatch.setattr(tce_mod, "default_cross_encoder_checkpoint", lambda: None)
        monkeypatch.setattr(jce_mod, "default_cross_encoder_checkpoint", lambda: None)
        jcfg, tcfg = JConfig().search, TConfig().search
        jcfg.reranker = tcfg.reranker = "cross_encoder"
        assert jrr.make_reranker_pipeline(None, jcfg).cross_encoder.cfg.hidden == 256
        with pytest.raises(FileNotFoundError, match="cross_encoder_r3.npz"):
            trr.make_reranker_pipeline(None, tcfg, device="cpu")
    elif case == "nonexistent_path":
        missing = os.path.join(REPO, "checkpoints", "no_such_cross_encoder.npz")
        assert JCE(checkpoint=missing).cfg.hidden == 256
        with pytest.raises(FileNotFoundError, match="no_such_cross_encoder"):
            TCE(checkpoint=missing, device="cpu")
    else:
        if torch.cuda.is_available():
            pytest.skip("a GPU is present: CUDA is no refusal there")
        with pytest.raises(RuntimeError, match="cuda"):
            TCE(hidden=32, n_layers=1)
        tcfg = TConfig().search
        tcfg.reranker = "cross_encoder"
        with pytest.raises(RuntimeError, match="cuda"):
            trr.make_reranker_pipeline(None, tcfg)


def test_random_init_takes_a_generator():
    a = TCE(hidden=32, n_layers=1, max_len=32, device="cpu",
            generator=torch.Generator().manual_seed(5))
    b = TCE(hidden=32, n_layers=1, max_len=32, device="cpu",
            generator=torch.Generator().manual_seed(5))
    c = TCE(hidden=32, n_layers=1, max_len=32, device="cpu", seed=6)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert torch.equal(a.head["w"], b.head["w"]) and not torch.equal(a.head["w"], c.head["w"])
    s = a.score_pairs("q", ["doc one", "doc two"])
    assert np.isfinite(s).all()

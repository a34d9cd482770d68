"""The port's provider chain (`codegraph_tpu_torch/models/providers.py`)
against the JAX package's on the CPU: the default configuration resolves to
the same chain, checkpoints cross both ways, and where the JAX package falls
back to hash embeddings the port raises (a missing checkpoint, an encoder
that fails, in the pipeline and in the resolver's semantic pass); rotation
stays for the HTTP providers that report themselves unavailable.
"""

import logging
import os
import shutil

import numpy as np
import pytest
import torch

import codegraph_tpu.models.providers as jprov
import codegraph_tpu_torch.models.providers as tprov
from codegraph_tpu.api import CodeGraph as JCodeGraph
from codegraph_tpu.core.config import CodeGraphConfig as JConfig
from codegraph_tpu.indexer.indexer import ProjectIndexer as JIndexer
from codegraph_tpu.indexer.resolve import EdgeResolver as JResolver
from codegraph_tpu_torch.api import CodeGraph as TCodeGraph
from codegraph_tpu_torch.core.config import CodeGraphConfig as TConfig
from codegraph_tpu_torch.core.errors import ProviderUnavailable
from codegraph_tpu_torch.indexer.indexer import ProjectIndexer as TIndexer
from codegraph_tpu_torch.indexer.resolve import EdgeResolver as TResolver
from codegraph_tpu_torch.models.encoder import EncoderConfig, init_encoder_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "encoder_r3_512.npz")


def test_default_config_resolves_to_the_same_chain():
    j = jprov.create_provider(JConfig())
    t = tprov.create_provider(TConfig(), device="cpu")
    assert type(t).__name__ == type(j).__name__ == "HybridEmbeddingPipeline"
    assert [p.name for p in t.providers] == [p.name for p in j.providers] == ["ensemble", "hash"]
    assert t.dimension == j.dimension == 768
    t_ens, j_ens = t.providers[0], j.providers[0]
    assert (t_ens.hash_dim, t_ens.w_enc) == (j_ens.hash_dim, j_ens.w_enc) == (256, 0.5)
    assert t_ens.encoder.cfg.hidden == j_ens.encoder.cfg.hidden == 512
    assert t_ens.encoder.buckets == j_ens.encoder.buckets == [64, 128, 192]
    assert type(t_ens.tokenizer).__name__ == type(j_ens.tokenizer).__name__ == "BPETokenizer"
    assert t_ens.tokenizer.merges == j_ens.tokenizer.merges
    assert {v.device.type for v in t_ens.encoder.params.values()} == {"cpu"}
    # the pipeline has no tokenizer in either package: the default chunker
    # counts bytes, not BPE tokens
    assert not hasattr(t, "tokenizer") and not hasattr(j, "tokenizer")
    assert TIndexer(TConfig(), provider=t, device="cpu")._count_tokens() is None
    assert JIndexer(JConfig(), provider=j)._count_tokens() is None
    texts = ["def load_config(path):", "hybrid search over the graph"]
    np.testing.assert_allclose(t.embed_texts(texts), j.embed_texts(texts), rtol=0, atol=2e-3)
    assert t.providers[1].metrics.texts == 0 and t_ens.encoder.metrics.texts == 2


def test_the_encoder_follows_the_requested_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        tprov.create_provider(TConfig())
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TIndexer(TConfig())
    cfg = TConfig()
    cfg.embedding.provider, cfg.embedding.fallbacks = "hash", []
    assert tprov.create_provider(cfg).name == "hash"  # no device work, no device
    indexer = TIndexer(TConfig(), device="cpu")
    enc = indexer.provider.providers[0].encoder
    assert enc.device.type == "cpu" and enc.params["tok_emb"].device.type == "cpu"


def test_missing_checkpoint_falls_back_in_jax_and_raises_in_port(monkeypatch, tmp_path):
    monkeypatch.setattr(jprov, "_default_checkpoint", lambda: None)
    monkeypatch.setattr(tprov, "_default_checkpoint", lambda: None)
    j = jprov.create_provider(JConfig())
    assert j.name == "hash"  # the ensemble was skipped
    with pytest.raises(ProviderUnavailable, match="needs a trained checkpoint"):
        tprov.create_provider(TConfig(), device="cpu")
    # a checkpoint path that does not exist: JAX builds a random encoder
    jcfg, tcfg = JConfig(), TConfig()
    jcfg.embedding.model = tcfg.embedding.model = str(tmp_path / "missing.npz")
    assert jprov.create_provider(jcfg).providers[0].name == "ensemble"
    with pytest.raises(ProviderUnavailable, match="missing.npz"):
        tprov.create_provider(tcfg, device="cpu")


def test_unknown_provider_raises_in_port_and_is_skipped_in_jax():
    for pkg, cfg in ((jprov, JConfig()), (tprov, TConfig())):
        with pytest.raises(Exception, match="unknown provider"):
            pkg.make_provider("nope", cfg.embedding)
    jcfg, tcfg = JConfig(), TConfig()
    jcfg.embedding.provider = tcfg.embedding.provider = "nope"
    assert jprov.create_provider(jcfg).name == "hash"
    with pytest.raises(ProviderUnavailable, match="unknown provider"):
        tprov.create_provider(tcfg, device="cpu")


def _break_encoders(monkeypatch):
    def boom(self, texts):
        raise RuntimeError("injected encoder failure")

    monkeypatch.setattr(jprov.EncoderProvider, "_embed", boom)
    monkeypatch.setattr(tprov.EncoderProvider, "_encode_texts", boom)


def test_failing_encoder_rotates_in_jax_and_raises_in_port(monkeypatch):
    _break_encoders(monkeypatch)
    j = jprov.create_provider(JConfig())
    t = tprov.create_provider(TConfig(), device="cpu")
    texts = ["alpha beta", "gamma"]
    got = j.embed_texts(texts)  # the JAX pipeline serves the hash provider's rows
    np.testing.assert_array_equal(got, j.providers[1].embed_texts(texts))
    with pytest.raises(RuntimeError, match="injected encoder failure"):
        t.embed_texts(texts)
    with pytest.raises(RuntimeError, match="injected encoder failure"):
        t.embed_texts_device(texts)
    assert t.providers[1].metrics.texts == 0


def test_failing_encoder_in_the_resolver(monkeypatch, caplog):
    """The semantic pass: the JAX resolver logs and resolves nothing; the
    port's lets the encoder's error out."""
    import codegraph_tpu.core.types as jt
    import codegraph_tpu_torch.core.types as tt

    _break_encoders(monkeypatch)

    def case(types):
        node = types.CodeNode.make("p", "load_configuration", types.NodeType.FUNCTION,
                                   types.Language.PYTHON, types.Location("a.py", 1, 2))
        edges = [types.CodeEdge(src=node.id, dst="load_config_file",
                                edge_type=types.EdgeType.CALLS, resolved=False)]
        return edges, {"load_configuration": [node]}

    j_enc = jprov.EncoderProvider(dimension=32, batch_size=4, max_len=64)
    t_enc = tprov.EncoderProvider(dimension=32, batch_size=4, max_len=64, device="cpu")
    edges, symbols = case(jt)
    with caplog.at_level(logging.WARNING):
        assert JResolver(j_enc)._semantic_match(edges, symbols) == 0
    assert "semantic match embedding failed" in caplog.text
    edges, symbols = case(tt)
    with pytest.raises(RuntimeError, match="injected encoder failure"):
        TResolver(t_enc)._semantic_match(edges, symbols)
    # an HTTP chain that reports itself unavailable is still skipped
    offline = tprov.HybridEmbeddingPipeline([tprov.OpenAIProvider(dimension=32)])
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert TResolver(offline)._semantic_match(edges, symbols) == 0


def test_failing_encoder_reaches_index(monkeypatch, tmp_path):
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "a.py").write_text("def alpha(x):\n    return beta(x) + 1\n\n"
                               "def beta(y):\n    return y * 2\n")
    _break_encoders(monkeypatch)
    jcfg, tcfg = JConfig(), TConfig()
    jcfg.data_dir, tcfg.data_dir = str(tmp_path / "j"), str(tmp_path / "t")
    stats = JCodeGraph.open(str(proj), config=jcfg).index()
    assert stats.chunks > 0  # indexed with hash embeddings
    cg = TCodeGraph.open(str(proj), config=tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="injected encoder failure"):
        cg.index()


def test_http_providers_rotate_when_unavailable(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    hash_p = tprov.HashProvider(64)
    # no API key: OpenAI reports itself unavailable and the chain moves on
    pipe = tprov.HybridEmbeddingPipeline([tprov.OpenAIProvider(dimension=64), hash_p])
    np.testing.assert_array_equal(pipe.embed_texts(["a b c"]), hash_p.embed_texts(["a b c"]))
    assert pipe._dead_until["openai"] > 0

    class Down(tprov.OllamaProvider):
        def is_available(self):
            return True

        def _embed(self, texts):
            raise ProviderUnavailable("ollama: connection refused")

    class Wrong(tprov.OllamaProvider):
        def is_available(self):
            return True

        def _embed(self, texts):
            return np.zeros((len(texts), 3), np.float32)

    # unavailable after its retries: rotates too
    pipe = tprov.HybridEmbeddingPipeline([Down(dimension=64), hash_p])
    np.testing.assert_array_equal(pipe.embed_texts(["x"]), hash_p.embed_texts(["x"]))
    assert pipe._dead_until["ollama"] > 0
    # an answer is served as it is; nothing left to try raises
    out = tprov.HybridEmbeddingPipeline([Wrong(dimension=64), hash_p]).embed_texts(["x"])
    assert out.shape == (1, 3)
    with pytest.raises(ProviderUnavailable, match="all providers failed"):
        tprov.HybridEmbeddingPipeline([tprov.OpenAIProvider(dimension=64)]).embed_texts(["x"])
    jina = tprov.make_provider("jina", TConfig().embedding)
    assert jina.batch_size == 256 and jina.url.endswith("/embeddings")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_both_ways(tmp_path, writer):
    import jax

    from codegraph_tpu.models.encoder import EncoderConfig as JEncCfg
    from codegraph_tpu.models.encoder import init_encoder_params as jinit

    kw = dict(vocab_size=260, hidden=32, n_layers=2, n_heads=4, max_len=64,
              norm_style="post", attn_bias=True, act="gelu_exact")
    path = str(tmp_path / "enc.npz")
    if writer == "jax":
        params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float16),
                                        jinit(jax.random.PRNGKey(1), JEncCfg(**kw)))
        jprov.save_encoder_checkpoint(path, params, cfg=JEncCfg(**kw), tokenizer_file="tok.json")
    else:
        params = {k: v.half() for k, v in
                  init_encoder_params(EncoderConfig(**kw), torch.Generator().manual_seed(1)).items()}
        tprov.save_encoder_checkpoint(path, params, cfg=EncoderConfig(**kw),
                                      tokenizer_file="tok.json")
    j_tree, j_meta = jprov.load_encoder_checkpoint_ex(path)
    t_tree, t_meta = tprov.load_encoder_checkpoint_ex(path)
    assert j_meta == t_meta and t_meta["tokenizer"] == "tok.json" and t_meta["n_heads"] == 4
    j_leaves = dict(jax.tree_util.tree_leaves_with_path(j_tree))
    t_leaves = dict(jax.tree_util.tree_leaves_with_path(t_tree))
    assert j_leaves.keys() == t_leaves.keys() and len(j_leaves) == 18
    for key, leaf in j_leaves.items():
        assert leaf.dtype == t_leaves[key].dtype == np.float16
        np.testing.assert_array_equal(leaf, t_leaves[key])
    j = jprov.EncoderProvider(checkpoint=path, batch_size=4)
    t = tprov.EncoderProvider(checkpoint=path, batch_size=4, device="cpu")
    assert (t.cfg.norm_style, t.cfg.attn_bias, t.cfg.act, t.cfg.n_heads) == \
        (j.cfg.norm_style, j.cfg.attn_bias, j.cfg.act, j.cfg.n_heads) == ("post", True,
                                                                          "gelu_exact", 4)
    assert t.dimension == j.dimension == 32
    # the port's save of what it loaded writes the same file contents back
    again = str(tmp_path / "again.npz")
    tprov.save_encoder_checkpoint(again, t.params, cfg=t.cfg, tokenizer_file="tok.json")
    a, b = np.load(path), np.load(again)
    assert sorted(a.files) == sorted(b.files)
    for name in a.files:
        np.testing.assert_array_equal(a[name], b[name])


def test_encoder_counters():
    t = tprov.EncoderProvider(batch_size=4, checkpoint=CKPT, device="cpu")
    texts = ["short", "x " * 100, "another short one"]
    t.embed_texts(texts)
    c = t.counters
    long_bucket = t._frame_rows([texts[1]])[0][0]
    assert long_bucket > 64
    assert c.texts == 3 and c.forwards == 2  # bucket 64: two rows; the long text's: one
    assert c.padded_tokens == 2 * 64 + long_bucket and 0 < c.tokens < c.padded_tokens
    assert c.tokenize_seconds > 0 and c.forward_seconds > 0
    assert set(c.to_dict()) == {"tokenize_seconds", "forward_seconds", "texts", "tokens",
                                "padded_tokens", "forwards"}


def test_default_project_indexer_uses_the_ensemble(tmp_path):
    proj = tmp_path / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "core"), proj,
                    ignore=shutil.ignore_patterns("__pycache__", "*.py[co]"))
    cfg = TConfig()
    cfg.data_dir = str(tmp_path / "d")
    cg = TCodeGraph.open(str(proj), config=cfg, device="cpu")
    assert [p.name for p in cg.indexer.provider.providers] == ["ensemble", "hash"]
    assert cg.indexer.index.dim == 768

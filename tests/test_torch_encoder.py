"""The port's encoder (`codegraph_tpu_torch/models/encoder.py`) and its
tokenizer copies, held to the JAX package on the CPU.

Small configs (2 layers, hidden 64, 4 heads, vocab 300, max_len 64) take
one set of numpy-seeded parameters into both packages
(`encoder_params_from_jax`). At f32 the port equals JAX's compiled
`encode_jit` within 1e-5 (the same arithmetic summed in another order). At
bf16 each sub-block (layer norm, attention, MLP) equals JAX's own jitted
sub-block on the same inputs but for an element in 1,000 that an f32 sum
in another order rounds to the neighbouring bf16 value; the whole forward differs from
JAX's compiled `encode_jit` by more, because XLA compiles the whole scan
with excess precision (it drops some of the source's f32 -> bf16 -> f32
round trips inside a fusion), so a value can land on the other side of a
bf16 rounding step, which later layers carry on. That gap is held to
BF16_TOL_SMALL at hidden 64 (measured up to 3.8e-3 over 8 seeds, cls
pooling the worst: it reads one token, so one flip is not averaged away;
JAX's own bf16 result sits 1.1e-3 to 3.4e-3 from its f32 one) and to
BF16_TOL at the shipped width. The shipped r3 checkpoint (6 layers, hidden
512) is held to BF16_TOL against the JAX package and against the golden
file that `tools/encoder_golden.py` wrote with it
(`tests/data/encoder_r3_golden.npz`).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.models import bpe as jbpe
from codegraph_tpu.models.encoder import EncoderConfig as JConfig
from codegraph_tpu.models.encoder import encode_jit as jencode
from codegraph_tpu.models.encoder import init_encoder_params as jinit
from codegraph_tpu.models.providers import EncoderProvider as JEncoderProvider
from codegraph_tpu.models.providers import EnsembleProvider as JEnsembleProvider
from codegraph_tpu.models.tokenizer import ByteTokenizer as JByteTokenizer
from codegraph_tpu_torch.models import bpe as tbpe
from codegraph_tpu_torch.models.encoder import EncoderConfig as TConfig
from codegraph_tpu_torch.models.encoder import encode as tencode
from codegraph_tpu_torch.models.encoder import (
    encoder_params_from_jax,
    encoder_params_to_jax,
    init_encoder_params,
)
from codegraph_tpu_torch.models.providers import EncoderProvider as TEncoderProvider
from codegraph_tpu_torch.models.providers import EnsembleProvider as TEnsembleProvider
from codegraph_tpu_torch.models.tokenizer import ByteTokenizer as TByteTokenizer

F32_TOL = 1e-5
# bf16 at the shipped width (hidden 512): measured up to 1.3e-3 on random ids
# and 6.4e-4 on the golden texts
BF16_TOL = 2e-3
# bf16 at hidden 64, against JAX's compiled forward (see above); the mean
# absolute gap is held to BF16_MEAN_TOL
BF16_TOL_SMALL = 5e-3
BF16_MEAN_TOL = 5e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "encoder_r3_512.npz")
GOLDEN = os.path.join(REPO, "tests", "data", "encoder_r3_golden.npz")

SMALL = dict(vocab_size=300, hidden=64, n_layers=2, n_heads=4, max_len=64)
VARIANTS = {
    "pre_tanh_mean": {},
    "post_bias_exact": dict(norm_style="post", attn_bias=True, act="gelu_exact"),
    "cls": dict(pooling="cls"),
    "max": dict(pooling="max"),
    "moe_dense": dict(n_experts=4),
    "no_normalize": dict(attn_bias=True),
}


def numpy_params(cfg: JConfig, seed: int = 0) -> dict:
    """A JAX-layout parameter tree of numpy f32 arrays from a numpy seed, with
    norm scales and biases away from 1 and 0 (trained weights are)."""
    shapes = jax.tree_util.tree_map(lambda a: a.shape, jinit(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def leaf(path, shape):
        name = str(path[-1].key)
        if name.endswith("_scale"):
            return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
        if name.startswith("b") or name.endswith("_bias"):
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def small_inputs(cfg, B=5, L=24, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, L)).astype(np.int32)
    lens = rng.integers(1, L + 1, B)
    mask = np.arange(L)[None, :] < lens[:, None]
    mask[-1] = False  # a fully padded row
    return ids, mask


def same_fields(jcfg, tcfg) -> bool:
    """The two EncoderConfigs agree on every field (dtypes are compared apart)."""
    want = {k: v for k, v in dataclasses.asdict(jcfg).items() if k != "dtype"}
    got = {k: v for k, v in dataclasses.asdict(tcfg).items() if k != "dtype"}
    return got == want


def both(variant, dtype_name):
    kw = VARIANTS[variant]
    jcfg = JConfig(**SMALL, **kw, dtype=jnp.float32 if dtype_name == "f32" else jnp.bfloat16)
    tcfg = TConfig(**SMALL, **kw, dtype=torch.float32 if dtype_name == "f32" else torch.bfloat16)
    return jcfg, tcfg


# JAX's CPU backend cannot run the bf16 dense MoE (its batched bf16 x bf16 ->
# f32 dot is unimplemented there), so the MoE is held to JAX at f32 only
CASES = [(v, d) for v in VARIANTS for d in ("f32", "bf16") if (v, d) != ("moe_dense", "bf16")]


@pytest.mark.parametrize("variant,dtype_name", CASES)
def test_small_encoder_matches_jax(variant, dtype_name):
    jcfg, tcfg = both(variant, dtype_name)
    tree = numpy_params(jcfg)
    ids, mask = small_inputs(jcfg)
    normalize = variant != "no_normalize"
    want = np.asarray(jencode(tree, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                              normalize=normalize))
    got = tencode(encoder_params_from_jax(tree), torch.from_numpy(ids),
                  torch.from_numpy(mask), tcfg, normalize=normalize)
    assert got.dtype == torch.float32 and got.shape == (5, 64)
    got = got.numpy()
    if dtype_name == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    else:
        if not normalize:  # pooled values of order 1: hold the unit-scaled rows
            scale = np.maximum(np.linalg.norm(want, axis=1, keepdims=True), 1e-12)
            got, want = got / scale, want / scale
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL_SMALL)
        assert np.abs(got - want).mean() <= BF16_MEAN_TOL
    if tcfg.pooling == "mean":
        # the fully padded row: uniform softmax, zero mean pool, zero output
        assert not np.isnan(got).any()
        assert (got[-1] == 0).all()


@pytest.mark.parametrize("variant", ["pre_tanh_mean", "post_bias_exact"])
def test_bf16_sub_blocks_equal_jax(variant):
    """Each sub-block on the same bf16 input: the port's casts are the JAX
    source's (bf16 operands, f32 sums, f32 bias/GELU/softmax, one rounding)."""
    import codegraph_tpu.models.encoder as J
    import codegraph_tpu_torch.models.encoder as T

    jcfg, tcfg = both(variant, "bf16")
    tree = numpy_params(jcfg)
    tp = encoder_params_from_jax(tree)
    ids, mask = small_inputs(jcfg)
    x = np.asarray(jnp.asarray(np.random.default_rng(3).standard_normal((5, 24, 64)),
                               jnp.bfloat16))
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    bias = jnp.where(jnp.asarray(mask)[:, None, None, :], 0.0, -1e30).astype(jnp.float32)
    lp = {k: v[1] for k, v in tree["layers"].items()}
    lpt = {k[len("layers."):]: v[1] for k, v in tp.items() if k.startswith("layers.")}
    approx = jcfg.act != "gelu_exact"
    pairs = [
        (jax.jit(J._layer_norm, static_argnums=3)(x, lp["ln1_scale"], lp["ln1_bias"], jcfg.eps),
         T._layer_norm(xt, lpt["ln1_scale"], lpt["ln1_bias"], tcfg.eps)),
        (jax.jit(lambda h: J._attention(h, lp["wqkv"], lp["wo"], bias, jcfg,
                                        b_qkv=lp.get("b_qkv"), b_o=lp.get("b_o")))(x),
         T._attention(xt, lpt["wqkv"], lpt["wo"], torch.from_numpy(np.array(bias)), tcfg,
                      b_qkv=lpt.get("b_qkv"), b_o=lpt.get("b_o"))),
        (jax.jit(lambda h: J._mlp(h, lp["w_up"], lp["b_up"], lp["w_down"], lp["b_down"],
                                  approx=approx))(x),
         T._mlp(xt, lpt["w_up"], lpt["b_up"], lpt["w_down"], lpt["b_down"], approx=approx)),
    ]
    for want, got in pairs:
        assert got.dtype == torch.bfloat16
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        # an f32 sum taken in another order may round to the neighbouring
        # bf16 value: at most 1 element in 1,000, one bf16 step (at most 2^-7
        # relative; 1e-6 absolute for values that cancel to near 0)
        assert (got != want).mean() <= 1e-3
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-6)


def test_params_keep_their_dtype_and_cross_back():
    jcfg = JConfig(**SMALL, attn_bias=True)
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float16), numpy_params(jcfg))
    params = encoder_params_from_jax(tree)
    assert all(v.dtype == torch.float16 for v in params.values())
    assert params["layers.wqkv"].shape == (2, 64, 192)
    back = encoder_params_to_jax(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat_a:
        assert flat_b[path].dtype == np.float16
        np.testing.assert_array_equal(flat_b[path], leaf)


@pytest.mark.parametrize("variant", ["pre_tanh_mean", "post_bias_exact", "moe_dense"])
def test_init_has_the_jax_layout(variant):
    jcfg, tcfg = both(variant, "f32")
    want = {".".join(str(k.key) for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_leaves_with_path(jinit(jax.random.PRNGKey(0), jcfg))}
    got = init_encoder_params(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == want
    assert all(v.dtype == torch.float32 for v in got.values())
    again = init_encoder_params(tcfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(got[k], again[k]) for k in got)


# -- the shipped r3 checkpoint -------------------------------------------------


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    return {k: g[k] for k in g.files}


@pytest.fixture(scope="module")
def r3_port():
    return TEncoderProvider(batch_size=32, checkpoint=CKPT, device="cpu")


def test_r3_config_from_the_checkpoint(r3_port):
    cfg = r3_port.cfg
    assert (cfg.hidden, cfg.n_layers, cfg.n_heads, cfg.mlp_hidden) == (512, 6, 16, 2048)
    assert (cfg.vocab_size, cfg.max_len, cfg.dtype) == (16644, 192, torch.bfloat16)
    assert r3_port.buckets == [64, 128, 192]
    assert isinstance(r3_port.tokenizer, tbpe.BPETokenizer)
    assert r3_port.tokenizer.vocab_size == 16644
    assert all(v.dtype == torch.float16 for v in r3_port.params.values())
    j = JEncoderProvider(batch_size=32, checkpoint=CKPT)
    assert same_fields(j.cfg, cfg)


def test_r3_encoder_against_the_golden_file(r3_port, golden):
    texts = [str(t) for t in golden["texts"]]
    rows = r3_port._frame_rows(texts)
    for i, (bucket, framed) in enumerate(rows):
        assert bucket == golden["bucket"][i]
        assert framed == golden["ids"][i][golden["mask"][i]].tolist()
    assert set(golden["bucket"].tolist()) == {64, 128, 192}
    got = r3_port.embed_texts(texts)
    assert got.shape == (32, 512)
    np.testing.assert_allclose(got, golden["encoder"], rtol=0, atol=BF16_TOL)
    ens = TEnsembleProvider(batch_size=32, checkpoint=CKPT, device="cpu")
    np.testing.assert_allclose(ens.embed_texts(texts), golden["ensemble"], rtol=0,
                               atol=BF16_TOL)


def test_r3_providers_match_jax(golden):
    """16 texts (every bucket) through both packages' EncoderProvider and
    EnsembleProvider; batch_size=16 so that JAX pads a group to 16 rows."""
    texts = [str(t) for t in golden["texts"][::2]]
    j_enc = JEncoderProvider(batch_size=16, checkpoint=CKPT)
    t_enc = TEncoderProvider(batch_size=16, checkpoint=CKPT, device="cpu")
    want, got = j_enc.embed_texts(texts), t_enc.embed_texts(texts)
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL)
    np.testing.assert_allclose(got, golden["encoder"][::2], rtol=0, atol=BF16_TOL)
    j_ens = JEnsembleProvider(batch_size=16, checkpoint=CKPT)
    t_ens = TEnsembleProvider(batch_size=16, checkpoint=CKPT, device="cpu")
    assert (t_ens.dimension, t_ens.hash_dim) == (j_ens.dimension, j_ens.hash_dim) == (768, 256)
    e_j, e_t = j_ens.embed_texts(texts), t_ens.embed_texts(texts)
    np.testing.assert_allclose(e_t, e_j, rtol=0, atol=BF16_TOL)
    # the lexical half is the hash embedder, copied: equal bit for bit
    np.testing.assert_array_equal(e_t[:, 512:], e_j[:, 512:])
    # the device path returns the same rows as a tensor
    dev = t_enc.embed_texts_device(texts)
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    np.testing.assert_allclose(dev.numpy(), got, rtol=0, atol=1e-6)


def test_group_padded_to_its_own_rows_keeps_each_row(golden):
    """The port pads a bucket group to its own row count; the JAX package
    pads it to batch_size. Rows are independent: at f32 every row equals
    the padded batch's to f32 rounding, at bf16 within BF16_TOL (another
    product shape may sum in another order)."""
    texts = [str(t) for t in golden["texts"]][8:20]  # every bucket
    prov = TEncoderProvider(batch_size=32, checkpoint=CKPT, device="cpu")
    batches = prov._batches(texts)
    assert sum(len(sel) for sel, _, _ in batches) == 12 and len(batches) == 3
    assert all(ids.shape[0] == len(sel) for sel, ids, _ in batches)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        cfg = dataclasses.replace(prov.cfg, dtype=dtype)
        for sel, ids, mask in batches:
            own = tencode(prov.params, torch.from_numpy(ids), torch.from_numpy(mask), cfg)
            pad_ids = np.full((16, ids.shape[1]), prov.tokenizer.pad_id, np.int32)
            pad_mask = np.zeros((16, ids.shape[1]), bool)
            pad_ids[:len(sel)], pad_mask[:len(sel)] = ids, mask
            padded = tencode(prov.params, torch.from_numpy(pad_ids),
                             torch.from_numpy(pad_mask), cfg)
            np.testing.assert_allclose(own.numpy(), padded[:len(sel)].numpy(), rtol=0, atol=tol)
            assert (padded[len(sel):] == 0).all()


# -- tokenizer and import copies ----------------------------------------------


def _repo_texts():
    out = []
    for rel in ("codegraph_tpu/models/bpe.py", "codegraph_tpu/search/hybrid.py",
                "codegraph_tpu/parser/scanners.py", "README.md"):
        with open(os.path.join(REPO, rel), encoding="utf-8") as f:
            text = f.read()
        out += [text[i:i + 700] for i in range(0, min(len(text), 21000), 700)]
    return out


def _random_texts(seed=0, n=60):
    rng = np.random.default_rng(seed)
    return [bytes(rng.integers(0, 256, rng.integers(0, 300)).astype(np.uint8))
            .decode("utf-8", errors="replace") for _ in range(n)] + ["", "\x00", "é中😀"]


def test_bpe_16k_ids_match_jax():
    path = os.path.join(REPO, "checkpoints", "bpe_code_16k.json")
    j, t = jbpe.make_tokenizer(path, max_len=192), tbpe.make_tokenizer(path, max_len=192)
    assert type(t).__name__ == type(j).__name__ == "BPETokenizer"
    for text in _repo_texts() + _random_texts():
        assert t.ids(text) == j.ids(text)
        assert t.encode(text) == j.encode(text)
        assert t.count_tokens(text) == j.count_tokens(text)
        assert t.decode(t.encode(text)) == j.decode(j.encode(text))
    ji, jm = j.encode_batch(["def f(x):", "", "x" * 500])
    ti, tm = t.encode_batch(["def f(x):", "", "x" * 500])
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tm, jm)


def test_byte_tokenizer_and_trained_bpe_match_jax(tmp_path):
    for text in _repo_texts()[:10] + _random_texts(1):
        assert TByteTokenizer(64).encode(text) == JByteTokenizer(64).encode(text)
        assert TByteTokenizer().count_tokens(text) == JByteTokenizer().count_tokens(text)
    corpus = _repo_texts()[:20]
    jt = jbpe.train_bpe(corpus, n_merges=200, max_len=64)
    tt = tbpe.train_bpe(corpus, n_merges=200, max_len=64)
    assert tt.merges == jt.merges
    tt.save(str(tmp_path / "t.json"))
    loaded = jbpe.make_tokenizer(str(tmp_path / "t.json"), max_len=64)
    for text in _random_texts(2, 20) + corpus[:5]:
        assert loaded.ids(text) == tt.ids(text)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\nhello\n##world\ndef\n##s\n")
    jw, tw = jbpe.make_tokenizer(str(vocab)), tbpe.make_tokenizer(str(vocab))
    for text in ("helloworld defs", "hello unknown", ""):
        assert tw.encode(text) == jw.encode(text)


@pytest.fixture(scope="module")
def tiny_bert(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    d = tmp_path_factory.mktemp("hfbert_torch")
    cfg = transformers.BertConfig(
        vocab_size=120, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=48,
    )
    torch.manual_seed(0)
    model = transformers.BertModel(cfg)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "LayerNorm" in name:
                p.add_(0.3 * torch.randn_like(p))
    model.eval()
    model.save_pretrained(str(d))
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    (d / "vocab.txt").write_text("\n".join(specials + [f"w{i}" for i in range(115)]) + "\n")
    return d, model


def test_hf_import_matches_jax_and_transformers(tiny_bert):
    from codegraph_tpu.models.hf_import import load_hf_encoder as jload
    from codegraph_tpu_torch.models.hf_import import is_hf_model_dir, load_hf_encoder

    d, model = tiny_bert
    assert is_hf_model_dir(str(d))
    tree, tcfg = load_hf_encoder(str(d))
    jtree, jcfg = jload(str(d))
    assert (tcfg.norm_style, tcfg.attn_bias, tcfg.act) == ("post", True, "gelu_exact")
    assert same_fields(jcfg, tcfg)
    tcfg = dataclasses.replace(tcfg, dtype=torch.float32)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    ids = rng.integers(5, 119, size=(3, 16)).astype(np.int32)
    mask = np.ones((3, 16), bool)
    mask[1, 10:] = False
    mask[2, 5:] = False
    got = tencode(encoder_params_from_jax(tree), torch.from_numpy(ids),
                  torch.from_numpy(mask), tcfg, normalize=False).numpy()
    want = np.asarray(jencode(jtree, jnp.asarray(ids), jnp.asarray(mask), jcfg,
                              normalize=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    with torch.no_grad():
        out = model(input_ids=torch.tensor(ids.astype(np.int64)),
                    attention_mask=torch.tensor(mask.astype(np.int64))).last_hidden_state.numpy()
    mf = mask.astype(np.float32)[:, :, None]
    np.testing.assert_allclose(got, (out * mf).sum(1) / mf.sum(1), rtol=2e-4, atol=2e-4)
    prov = TEncoderProvider(checkpoint=str(d), device="cpu")
    assert prov.dimension == 32 and type(prov.tokenizer).__name__ == "WordPieceTokenizer"
    jprov = JEncoderProvider(checkpoint=str(d), batch_size=2)
    texts = ["w1 w2 w3", "w4"]
    np.testing.assert_allclose(prov.embed_texts(texts), jprov.embed_texts(texts),
                               rtol=0, atol=BF16_TOL)

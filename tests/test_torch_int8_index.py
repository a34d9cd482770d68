"""The port's Int8FlatIndex held to the JAX package's Int8FlatIndex on the CPU.

Both indexes get the same numpy vectors (seeded); the JAX index searches
with its XLA `streaming_topk_int8` (its CPU path), the port's with the
plain version behind the K5/K6 wrappers.

Tolerances:
* Stored banks after `add`: with metric "dot" the int8 rows and scales are
  equal element for element (the same quantizer on the same f32 rows).
  With "cosine" the f32 norms of XLA and torch may differ in the last bit,
  so an int8 element may land one step away (at most 1 in 1,000 here) and
  a scale differs by at most 1e-6 relative; a bf16 rescore row by at most
  one bf16 step (rtol 2**-7).
* Searches run on identical state (the port loads the JAX index's arrays):
  scores within 1e-5 (rescored f32 dot products are summed in another
  order; unit-norm rows give scores in [-1, 1]); ids equal except where
  the scores tie within that bound.
"""

import numpy as np
import pytest
import torch

from codegraph_tpu.index.int8_flat import Int8FlatIndex as JInt8
from codegraph_tpu_torch.index import int8_flat as tint8
from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex as TInt8
from codegraph_tpu_torch.ops import quantize as tq
from codegraph_tpu_torch.ops.topk import NEG_INF

from tests.test_torch_topk import assert_topk_equiv

TOL = 1e-5
D = 64


def _rows(rng, n):
    return rng.standard_normal((n, D)).astype(np.float32)


def _pair(rescore, metric="cosine", rescore_k=50, tile_n=256):
    kw = dict(metric=metric, rescore_dtype=rescore, rescore_k=rescore_k, tile_n=tile_n)
    return JInt8(D, **kw), TInt8(D, device="cpu", **kw)


def _loaded(j, rescore, metric="cosine", rescore_k=50):
    """The port's index holding exactly the JAX index's state."""
    t = TInt8(D, metric=metric, rescore_dtype=rescore, rescore_k=rescore_k, tile_n=256,
              device="cpu")
    q, s, r, bias = j.arrays()
    t.load_arrays(np.asarray(q), np.asarray(s), None if r is None else np.asarray(r, np.float32),
                  np.asarray(bias), j.n_rows, j.n_live)
    return t


def _judge(t, q, extra_bias=None):
    """[B, cap] true scores of the port's final ranking: the rescore copy's
    f32 dot products, or the int8 scores without one."""
    qv_, s_, r_, bias = (a if a is None else a.clone() for a in t.arrays())
    bias = bias.numpy()
    if extra_bias is not None:
        bias[: len(extra_bias)] += extra_bias
    qt = torch.from_numpy(q)
    if t.metric == "cosine":
        qt = torch.nn.functional.normalize(qt, dim=1)
    if r_ is not None:
        return qt.double().numpy() @ r_.double().numpy().T + bias[None, :]
    qv, qs = tq.quantize_rows(qt)
    return (tq.int8_scores(qv, qs, qv_, s_).numpy() + bias[None, :]).astype(np.float64)


def _assert_same(j, t, q, k, extra_bias=None):
    js, ji = j.search(q, k, extra_bias=extra_bias)
    ts, ti = t.search(q, k, extra_bias=extra_bias)
    assert ts.shape == js.shape == (q.shape[0], k)
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    assert_topk_equiv(ts, ti, js, ji, None, None, None, tol=TOL, true=_judge(t, q, extra_bias))
    np.testing.assert_array_equal(ti < 0, ji < 0)  # dead rows and padding: -1 in both
    assert (ts[ti < 0] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("rescore,metric", [("float32", "cosine"), ("bfloat16", "cosine"),
                                            (None, "dot")])
@pytest.mark.parametrize("B", [4, 40])  # K5 path, K6 path
def test_add_delete_search_match_jax(rng, rescore, metric, B):
    j, t = _pair(rescore, metric)
    for n in (300, 500):  # two adds -> one capacity growth
        v = _rows(rng, n)
        np.testing.assert_array_equal(j.add(v), t.add(v))
    dead = rng.choice(800, size=40, replace=False)
    j.delete(dead)
    t.delete(dead)
    assert (len(j), j.n_rows, j.capacity) == (len(t), t.n_rows, t.capacity) == (760, 800, 1024)
    qj, sj, rj, bj = (None if a is None else np.asarray(a, np.float32 if a.dtype != np.int8
                                                          else np.int8) for a in j.arrays())
    qt, st, rt, bt = t.arrays()
    dq = np.abs(qt.numpy().astype(np.int32) - qj.astype(np.int32))
    if metric == "dot":
        assert dq.max() == 0
        np.testing.assert_array_equal(st.numpy(), sj)
    else:
        assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3
        np.testing.assert_allclose(st.numpy(), sj, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    if rescore is None:
        assert rt is None and rj is None
    else:
        assert rt.dtype == getattr(torch, rescore)
        np.testing.assert_allclose(rt.float().numpy(), rj,
                                   rtol=2.0**-7 if rescore == "bfloat16" else 1e-6, atol=1e-7)
    q = _rows(rng, B)
    t = _loaded(j, rescore, metric)
    _assert_same(j, t, q, 10)
    _assert_same(j, t, q, 50)


@pytest.mark.parametrize("rescore", ["bfloat16", None])
def test_extra_bias_filter_matches_jax(rng, rescore):
    metric = "dot" if rescore is None else "cosine"
    j, _ = _pair(rescore, metric)
    j.add(_rows(rng, 400))
    t = _loaded(j, rescore, metric)
    eb = np.where(rng.random(350) < 0.5, NEG_INF, 0.0).astype(np.float32)
    q = _rows(rng, 3)
    _assert_same(j, t, q, 20, extra_bias=eb)
    _, ti = t.search(q, 20, extra_bias=eb)
    assert not np.isin(ti, np.nonzero(eb < 0)[0]).any()


def test_k_above_capacity_pads_like_jax(rng):
    j, t = _pair("float32", tile_n=16)
    v = _rows(rng, 20)
    j.add(v)
    t.add(v)
    j.delete([0, 1])
    t.delete([0, 1])
    assert t.capacity == j.capacity == 32
    q = _rows(rng, 2)
    js, ji = j.search(q, 2000)
    ts, ti = t.search(q, 2000)
    assert ts.shape == js.shape == (2, 2000)
    np.testing.assert_array_equal(ti < 0, ji < 0)
    assert (ti >= 0).sum(axis=1).tolist() == [18, 18]
    np.testing.assert_allclose(ts[:, :18], js[:, :18], atol=TOL)


def test_reserve_growth_and_empty_index(rng):
    j, t = _pair("bfloat16", tile_n=2048)
    q = _rows(rng, 3)
    js, ji = j.search(q, 5)  # empty index
    ts, ti = t.search(q, 5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    j.reserve(5000)
    t.reserve(5000)
    assert t.capacity == j.capacity == 6144
    for n in (10, 6000):  # the second add grows past the reservation
        v = _rows(rng, n)
        j.add(v)
        t.add(v)
        assert (t.capacity, t.n_rows, len(t)) == (j.capacity, j.n_rows, len(j))
    qt, st, rt, bt = t.arrays()
    assert qt.shape == (t.capacity, D) and rt.shape == (t.capacity, D)
    assert (bt.numpy()[6010:] == np.float32(NEG_INF)).all()
    _assert_same(j, _loaded(j, "bfloat16"), _rows(rng, 4), 10)


@pytest.mark.parametrize("B,want", [(1, "K5"), (31, "K5"), (32, "K6"), (64, "K6")])
def test_search_takes_k5_below_32_and_k6_above(rng, monkeypatch, B, want):
    """The kernel chosen by batch size, as `int8_flat.py:183-205` of the
    reference: K5 for B < 32, K6 for B >= 32 (the QueryService buckets)."""
    calls = []
    for name, tag in (("streaming_topk_int8_cuda", "K5"),
                      ("streaming_topk_int8_cuda_qmajor", "K6")):
        fn = getattr(tint8, name)
        monkeypatch.setattr(tint8, name,
                            lambda *a, _fn=fn, _tag=tag, **kw: calls.append(_tag) or _fn(*a, **kw))
    t = TInt8(D, rescore_k=20, device="cpu")
    t.add(_rows(rng, 100))
    s, i = t.search(_rows(rng, B), 5)
    assert calls == [want] and s.shape == (B, 5) and (i >= 0).all()


def test_load_arrays_from_jax_index_and_rescore_cast(rng):
    j = JInt8(D, rescore_dtype="float32", rescore_k=30, tile_n=256)
    j.add(_rows(rng, 300))
    j.delete([5, 6, 7])
    q, s, r, bias = (np.asarray(a) for a in j.arrays())
    t = TInt8(D, rescore_dtype="bfloat16", rescore_k=30, device="cpu")
    t.load_arrays(q, s, r, bias, j.n_rows, j.n_live)
    assert t.device.type == "cpu" and (t.capacity, len(t), t.n_rows) == (j.capacity, 297, 300)
    assert t.arrays()[2].dtype == torch.bfloat16
    t_none = TInt8(D, rescore_dtype=None, device="cpu")
    t_none.load_arrays(q, s, r, bias, j.n_rows, j.n_live)  # kept as given, as the reference does
    assert t_none.arrays()[2].dtype == torch.float32
    t_none.load_arrays(q, s, None, bias, j.n_rows, j.n_live)
    assert t_none.arrays()[2] is None
    with pytest.raises(ValueError, match="scales"):
        t.load_arrays(q, s[:-1], r, bias, j.n_rows, j.n_live)


def test_add_accepts_tensors_and_rejects_bad_dims(rng):
    t = TInt8(D, device="cpu")
    assert t.add(torch.from_numpy(_rows(rng, 8))).tolist() == list(range(8))
    assert len(t) == 8
    from codegraph_tpu_torch.core.errors import DimensionMismatch

    with pytest.raises(DimensionMismatch):
        t.add(np.zeros((2, D + 1), np.float32))
    with pytest.raises(DimensionMismatch):
        t.search(np.zeros((2, D - 1), np.float32), 3)
    with pytest.raises(ValueError, match="rescore_dtype"):
        TInt8(D, rescore_dtype="float16", device="cpu")


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        TInt8(D)  # device defaults to "cuda"


#: embedding widths users configure that are not a multiple of 16 (so
#: K6/K7 take the ragged producer on a card; 25 and 1 are not a multiple of
#: 4 either, so K5 realigns its words)
RAGGED_WIDTHS = (1, 25, 100, 300)


@pytest.mark.parametrize("D_", RAGGED_WIDTHS)
@pytest.mark.parametrize("B", [4, 40])  # K5 path, K6 path
def test_ragged_widths_match_jax(rng, D_, B):
    """An int8 index at a width that is not a multiple of 16 against JAX's:
    a ragged N, 1% tombstones, an extra_bias filter, k above the live
    rows, the bf16 rescore."""
    kw = dict(metric="cosine", rescore_dtype="bfloat16", rescore_k=50, tile_n=256)
    j = JInt8(D_, **kw)
    j.add(rng.standard_normal((203, D_)).astype(np.float32))
    j.delete(rng.choice(203, size=2, replace=False))
    t = TInt8(D_, device="cpu", **kw)
    qa, sa, ra, ba = j.arrays()
    t.load_arrays(np.asarray(qa), np.asarray(sa), np.asarray(ra, np.float32), np.asarray(ba),
                  j.n_rows, j.n_live)
    eb = np.where(rng.random(203) < 0.1, NEG_INF, 0.0).astype(np.float32)
    q = rng.standard_normal((B, D_)).astype(np.float32)
    for k in (10, 250):
        _assert_same(j, t, q, k, extra_bias=eb)


@pytest.mark.parametrize("D_", RAGGED_WIDTHS)
@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_ragged_width_scans_match_jax_pallas(rng, D_, kernel):
    """The int8 scans at those widths against JAX's Pallas kernels in
    interpret mode (their blocks span the whole row, any D): K5 at B = 5,
    K6 at B = 40 (the route a card takes there: K5r or K5, K6r), with
    tombstones, a filter and k above the live rows; the port's wrappers run
    their plain version on CPU tensors."""
    from codegraph_tpu.ops import quantize as jq

    B, tile_b = (5, 8) if kernel == "K5" else (40, 16)
    x = rng.standard_normal((203, D_)).astype(np.float32)
    qv, qs = (np.array(a) for a in jq.quantize_rows(rng.standard_normal((B, D_))
                                                        .astype(np.float32)))
    xv, xs = (np.array(a) for a in jq.quantize_rows(x))
    bias = np.where(rng.random(203) < 0.1, NEG_INF, 0.0).astype(np.float32)
    bias[:2] = NEG_INF
    jfn = jq.streaming_topk_int8_pallas if kernel == "K5" else jq.streaming_topk_int8_qmajor
    tfn = tq.streaming_topk_int8_cuda if kernel == "K5" else tq.streaming_topk_int8_cuda_qmajor
    b_pad = -(-B // tile_b) * tile_b
    # the Pallas kernels take whole tiles: the corpus padded to 256 dead
    # rows (as an index's capacity pads it); the port gets the 203 rows
    n_pad = 256 - len(x)
    padded = (np.pad(xv, ((0, n_pad), (0, 0))), np.pad(xs, (0, n_pad)),
              np.pad(bias, (0, n_pad), constant_values=NEG_INF))
    for k in (10, 250):
        js, ji = jfn(np.pad(qv, ((0, b_pad - B), (0, 0))), np.pad(qs, (0, b_pad - B)), *padded,
                     k, tile_n=128, tile_b=tile_b, interpret=True)
        ts, ti = tfn(*(torch.from_numpy(a) for a in (qv, qs, xv, xs, bias)), k)
        raw = (qv.astype(np.int64) @ xv.astype(np.int64).T).astype(np.float32)
        true = (raw * qs[:, None] * xs[None, :] + bias[None, :]).astype(np.float64)
        assert_topk_equiv(ts, ti, np.asarray(js)[:B], np.asarray(ji)[:B], None, None, None,
                          tol=1e-6, true=true)

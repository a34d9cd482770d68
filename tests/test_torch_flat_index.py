"""The port's FlatIndex held to the JAX package's FlatIndex on the CPU.

Both indexes get the same numpy vectors (seeded). The JAX index searches
with its Pallas kernels in interpret mode (`backend="pallas"`), which is
the path that rounds a bf16 index's queries to bf16, as the port does.
Tolerances: 1e-5 absolute on scores of unit-norm vectors (summation
order differs); ids equal except where scores tie within that bound.
Stored rows: f32 within 1e-6; bf16 within one bf16 step (rtol 2**-7,
the spacing of bf16 values), because the f32 norms may differ in the
last bit before the rows round to bf16. So the search checks run on
identical state: the port's index loads the JAX index's arrays.
"""

import numpy as np
import pytest
import torch

from codegraph_tpu.index.flat import FlatIndex as JFlat
from codegraph_tpu_torch.index.flat import FlatIndex as TFlat
from codegraph_tpu_torch.ops import topk as ttopk

from tests.test_torch_topk import assert_topk_equiv

TOL = 1e-5


def _pair(dtype, D=64):
    return (JFlat(D, dtype=dtype, backend="pallas"),
            TFlat(D, dtype=dtype, device="cpu"))


def _rows(rng, n, D=64):
    return rng.standard_normal((n, D)).astype(np.float32)


def _loaded(j, dtype):
    """The port's index holding exactly the JAX index's state."""
    x, bias = j.arrays()
    return TFlat.from_arrays(np.asarray(x, np.float32), np.asarray(bias), j.n_rows,
                             j.n_live, dtype=dtype, device="cpu")


def _search_both(j, t, q, k, extra_bias=None):
    js, ji = j.search(q, k, extra_bias=extra_bias)
    ts, ti = t.search(q, k, extra_bias=extra_bias)
    return js, ji, ts, ti


def _assert_same(j, t, q, k, extra_bias=None):
    js, ji, ts, ti = _search_both(j, t, q, k, extra_bias)
    assert ts.shape == js.shape == (q.shape[0], k)
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    x, bias = t.arrays()
    qn = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-6)
    qn = torch.from_numpy(qn.astype(np.float32)).to(t.dtype).float().numpy()
    full_bias = bias.numpy().copy()
    if extra_bias is not None:
        full_bias[: len(extra_bias)] += extra_bias
    assert_topk_equiv(ts, ti, js, ji, qn, x.float().numpy(), full_bias, tol=TOL)
    # dead rows and padding are -1 with NEG_INF scores in both
    np.testing.assert_array_equal(ti < 0, ji < 0)
    assert (ts[ti < 0] == np.float32(ttopk.NEG_INF)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [4, 40])  # K1 path, K2 path
def test_add_delete_search_match_jax(rng, dtype, B):
    j, t = _pair(dtype)
    for n in (300, 500):  # two adds -> one capacity growth
        v = _rows(rng, n)
        np.testing.assert_array_equal(j.add(v), t.add(v))
    dead = rng.choice(800, size=40, replace=False)
    j.delete(dead)
    t.delete(dead)
    assert (len(j), j.n_rows, j.capacity) == (len(t), t.n_rows, t.capacity) == (760, 800, 1024)
    xj, bj = j.arrays()
    xt, bt = t.arrays()
    if dtype == "float32":
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(xt.float().numpy(), np.asarray(xj, np.float32),
                                   rtol=2.0**-7, atol=0)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    q = _rows(rng, B)
    t = _loaded(j, dtype)
    _assert_same(j, t, q, 10)
    _assert_same(j, t, q, 30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extra_bias_filter_matches_jax(rng, dtype):
    j, _ = _pair(dtype)
    j.add(_rows(rng, 400))
    t = _loaded(j, dtype)
    eb = np.where(rng.random(350) < 0.5, ttopk.NEG_INF, 0.0).astype(np.float32)
    q = _rows(rng, 3)
    _assert_same(j, t, q, 20, extra_bias=eb)
    _, ti = t.search(q, 20, extra_bias=eb)
    assert not np.isin(ti, np.nonzero(eb < 0)[0]).any()


def test_k_above_capacity_pads_like_jax(rng):
    j, t = _pair("float32")
    v = _rows(rng, 20)
    j.add(v)
    t.add(v)
    j.delete([0, 1])
    t.delete([0, 1])
    q = _rows(rng, 2)
    js, ji, ts, ti = _search_both(j, t, q, 2000)
    assert ts.shape == js.shape == (2, 2000)
    np.testing.assert_array_equal(ti < 0, ji < 0)
    assert (ti >= 0).sum(axis=1).tolist() == [18, 18]
    np.testing.assert_allclose(ts[:, :18], js[:, :18], atol=TOL)


def test_reserve_empty_and_get_vectors(rng):
    j, t = _pair("float32")
    q = _rows(rng, 3)
    js, ji, ts, ti = _search_both(j, t, q, 5)  # empty index
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    j.reserve(5000)
    t.reserve(5000)
    assert t.capacity == j.capacity == 5120
    v = _rows(rng, 10)
    j.add(v)
    t.add(v)
    assert t.capacity == 5120
    np.testing.assert_allclose(t.get_vectors([3, 7]), j.get_vectors([3, 7]), atol=1e-6)


def test_load_arrays_from_jax_index(rng):
    j = JFlat(64, backend="pallas")
    j.add(_rows(rng, 300))
    j.delete([5, 6, 7])
    x, bias = j.arrays()
    t = TFlat.from_arrays(np.asarray(x), np.asarray(bias), j.n_rows, j.n_live, device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.float32
    assert (t.capacity, len(t)) == (j.capacity, len(j))
    _assert_same(j, t, _rows(rng, 5), 25)


def test_add_accepts_tensors(rng):
    t = TFlat(64, device="cpu")
    rows = t.add(torch.from_numpy(_rows(rng, 8)))
    assert rows.tolist() == list(range(8))
    assert len(t) == 8


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; this checks the no-GPU refusal")
    with pytest.raises(RuntimeError, match="cuda"):
        TFlat(64)  # device defaults to "cuda"


def test_unported_dtype_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        TFlat(64, dtype="int8", device="cpu")

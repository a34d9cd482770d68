"""The port's int8 ops (`codegraph_tpu_torch.ops.quantize`) held to the JAX
package.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it on the CPU: the XLA
`streaming_topk_int8` and the Pallas kernels K5/K6/K7 in interpret mode.
The port's K5/K6/K7 wrappers get CPU tensors here, so they run their plain
version; the CUDA kernel itself is held to it on the card (`chip_smoke.py`,
and `test_int8_kernels_match_plain_on_card` below where a GPU is present).

Tolerances:
* quantize_rows / dequantize_rows / int8_scores: equal element for element
  (the same f32 operations in the same order; round is half to even in
  both libraries).
* int8 top-k: ids equal except where the f32 scores tie; scores within
  1e-6 (both sides compute the exact int32 dot, then the same two f32
  products and one f32 sum).
* rescore_topk: scores within 1e-5, the f32 dot products summed in another
  order (unit-norm rows give scores in [-1, 1]).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.ops import quantize as jq
from codegraph_tpu_torch.ops import quantize as tq
from codegraph_tpu_torch.ops.topk import NEG_INF

from tests.test_torch_topk import _t, _unit, assert_topk_equiv

SCORE_TOL = 1e-6


def _int8_true(qv, qs, xv, xs, bias):
    """The reference's f32 scores, computed in numpy: the exact integer dot,
    then * qs, * xs and + bias, each rounded to f32."""
    raw = (np.asarray(qv, np.int64) @ np.asarray(xv, np.int64).T).astype(np.float32)
    return (raw * np.asarray(qs)[:, None] * np.asarray(xs)[None, :]
            + np.asarray(bias)[None, :]).astype(np.float32)


def _int8_case(rng, B, N, D, dead_frac=0.01):
    q = _unit(rng.standard_normal((B, D)))
    x = _unit(rng.standard_normal((N, D)))
    x[min(7, N - 1)] = 0.0  # an all-zero row gets scale 0
    qv, qs = (np.array(a) for a in jq.quantize_rows(q))
    xv, xs = (np.array(a) for a in jq.quantize_rows(x))
    bias = np.zeros(N, np.float32)
    if dead_frac:
        bias[rng.choice(N, size=max(1, int(N * dead_frac)), replace=False)] = NEG_INF
    return qv, qs, xv, xs, bias


def _assert_int8_equiv(s, i, ref_s, ref_i, case):
    assert_topk_equiv(s, i, ref_s, ref_i, None, None, None, tol=SCORE_TOL,
                      true=_int8_true(*case))


@pytest.mark.parametrize("N,D,scale", [(4096, 128, 1.0), (300, 64, 1e-3), (17, 36, 1e4)])
def test_quantize_rows_matches_jax(rng, N, D, scale):
    x = (scale * rng.standard_normal((N, D))).astype(np.float32)
    x[0] = 0.0                                 # scale 0, q 0
    x[1] = np.linspace(-1.0, 1.0, D)           # values on the half-step grid
    x[2, :] = 127.0                            # exact +-127
    x[3] = -x[2]
    x[4] = (np.arange(D) - D // 2) / 2.0 * (127.0 / (D / 2.0))  # .5 ties after scaling
    jv, js = jq.quantize_rows(x)
    tv, ts = tq.quantize_rows(torch.from_numpy(x))
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tv.numpy()[0] == 0).all() and ts.numpy()[0] == 0
    assert (tv.numpy()[2] == 127).all() and (tv.numpy()[3] == -127).all()
    np.testing.assert_array_equal(tq.dequantize_rows(tv, ts).numpy(),
                                  np.asarray(jq.dequantize_rows(jv, js)))


def test_int8_scores_match_jax(rng):
    qv, qs, xv, xs, _ = _int8_case(rng, 6, 200, 64)
    want = np.asarray(jq.int8_scores(qv, qs, xv, xs))
    got = tq.int8_scores(*_t(qv, qs, xv, xs)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("D", [64, 1040, 1044])
def test_int8_dot_is_exact_at_plus_minus_127(D):
    """Rows of +-127 everywhere: an int8 torch.mm wraps, the plain version
    sums 127^2 * D exactly (int32 on the CPU)."""
    qv = torch.full((3, D), 127, dtype=torch.int8)
    qv[1] = -127
    xv = torch.full((5, D), 127, dtype=torch.int8)
    xv[2] = -127
    assert torch.mm(qv, xv.T).dtype == torch.int8  # the trap the plain version avoids
    got = tq.int8_dot(qv, xv).numpy()
    want = (qv.numpy().astype(np.int64) @ xv.numpy().astype(np.int64).T).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == np.float32(127 * 127 * D)
    assert got[1, 0] == -got[0, 0] and got[1, 2] == got[0, 0]
    jax_raw = np.asarray(jq.int8_scores(qv.numpy(), np.ones(3, np.float32), xv.numpy(),
                                        np.ones(5, np.float32)))
    np.testing.assert_array_equal(got, jax_raw)


@pytest.mark.parametrize("B,N,D,k,tile_n", [
    (4, 512, 64, 10, 128),
    (3, 1024, 128, 100, 256),
    (40, 4096, 128, 300, 512),
    (33, 768, 36, 5, 256),
])
def test_streaming_topk_int8_matches_jax_xla(rng, B, N, D, k, tile_n):
    case = _int8_case(rng, B, N, D)
    js, ji = jq.streaming_topk_int8(*(jnp.asarray(a) for a in case), k, tile_n=tile_n)
    ts, ti = tq.streaming_topk_int8(*_t(*case), k, tile_n=tile_n)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    _assert_int8_equiv(ts, ti, js, ji, case)


@pytest.mark.parametrize("N,tile_n", [(1000, 128), (300, 1024), (1, 64)])
def test_streaming_topk_int8_ragged_n(rng, N, tile_n):
    """The port's plain version takes any N (the JAX one needs N % tile_n
    == 0): it equals the JAX scan over the corpus padded with dead rows."""
    case = _int8_case(rng, 3, N, 64, dead_frac=0.0)
    k = min(7, N)
    pad = -(-N // tile_n) * tile_n - N
    padded = list(case)
    padded[2] = np.pad(case[2], ((0, pad), (0, 0)))
    padded[3] = np.pad(case[3], (0, pad))
    padded[4] = np.pad(case[4], (0, pad), constant_values=NEG_INF)
    js, ji = jq.streaming_topk_int8(*(jnp.asarray(a) for a in padded), k, tile_n=tile_n)
    ts, ti = tq.streaming_topk_int8(*_t(*case), k, tile_n=tile_n)
    _assert_int8_equiv(ts, ti, js, ji, case)


@pytest.mark.parametrize("kernel,B,k", [
    ("K5", 1, 10), ("K5", 8, 100), ("K5", 5, 300),
    ("K6", 32, 10), ("K6", 64, 100),
    ("K7", 32, 10), ("K7", 48, 100),
])
def test_int8_wrappers_match_jax_pallas(rng, kernel, B, k):
    """K5/K6/K7 wrappers (plain path on CPU tensors) vs the Pallas kernels
    in interpret mode, with tombstones and a zero row."""
    N, D = 1024, 64
    case = _int8_case(rng, B, N, D)
    jfn, tfn, tile_b = {
        "K5": (jq.streaming_topk_int8_pallas, tq.streaming_topk_int8_cuda, 8),
        "K6": (jq.streaming_topk_int8_qmajor, tq.streaming_topk_int8_cuda_qmajor, 16),
        "K7": (jq.streaming_topk_int8_qres, tq.streaming_topk_int8_cuda_qres, 16),
    }[kernel]
    qv, qs = case[0], case[1]
    b_pad = -(-B // tile_b) * tile_b  # the Pallas kernels take whole query tiles
    qv_p = np.pad(qv, ((0, b_pad - B), (0, 0)))
    qs_p = np.pad(qs, (0, b_pad - B))
    js, ji = jfn(jnp.asarray(qv_p), jnp.asarray(qs_p), *(jnp.asarray(a) for a in case[2:]), k,
                 tile_n=256, tile_b=tile_b, interpret=True)
    js, ji = np.asarray(js)[:B], np.asarray(ji)[:B]
    ts, ti = tfn(*_t(*case), k)
    _assert_int8_equiv(ts, ti, js, ji, case)


def test_int8_ties_and_filter(rng):
    """Duplicate rows score identically (the lower row id first); a NEG_INF
    filter on top of a tombstone never enters; k above the live count
    pads with (NEG_INF, -1)."""
    qv, qs, xv, xs, bias = _int8_case(rng, 2, 64, 16, dead_frac=0.0)
    xv[40], xs[40] = xv[3], xs[3]
    xv[63], xs[63] = xv[3], xs[3]
    qv[0] = xv[3]
    bias[10:20] = NEG_INF
    bias[15:25] += NEG_INF
    ts, ti = tq.streaming_topk_int8_cuda(*_t(qv, qs, xv, xs, bias), 60, tile_n=16)
    ti = ti.numpy()
    assert ti[0, :3].tolist() == [3, 40, 63]
    assert not np.isin(ti, np.arange(10, 25)).any()
    assert (ti[:, :49] >= 0).all() and (ti[:, 49:] == -1).all()
    assert (ts.numpy()[:, 49:] == np.float32(NEG_INF)).all()


def test_rescore_topk_matches_jax(rng):
    B, C, N, D = 5, 40, 300, 64
    q = _unit(rng.standard_normal((B, D)))
    x = _unit(rng.standard_normal((N, D)))
    x[11] = x[4]  # a tie: the scan's order decides
    ids = np.stack([rng.permutation(N)[:C] for _ in range(B)]).astype(np.int32)
    ids[0, :2] = [4, 11]
    ids[:, -5:] = -1  # padding candidates
    cand = np.zeros((B, C), np.float32)
    for k in (10, C):
        js, ji = jq.rescore_topk(q, x, ids, cand, k)
        ts, ti = tq.rescore_topk(*_t(q, x, ids, cand), k)
        assert ts.dtype == torch.float32 and ti.dtype == torch.int32
        assert_topk_equiv(ts, ti, js, ji, q, x, np.zeros(N, np.float32), tol=1e-5)
    ts, ti = tq.rescore_topk(*_t(q, x, ids, cand), C)
    assert (ti.numpy()[:, -5:] == -1).all() and (ts.numpy()[:, -5:] == np.float32(NEG_INF)).all()
    bf = torch.from_numpy(x).to(torch.bfloat16)  # a bf16 rescore copy widens exactly
    js, ji = jq.rescore_topk(q, jnp.asarray(bf.float().numpy(), jnp.bfloat16), ids, cand, 10)
    ts, ti = tq.rescore_topk(torch.from_numpy(q), bf, torch.from_numpy(ids),
                             torch.from_numpy(cand), 10)
    assert_topk_equiv(ts, ti, js, ji, q, bf.float().numpy(), np.zeros(N, np.float32), tol=1e-5)


@pytest.mark.parametrize("bad,err", [
    (dict(k=0), "k=0"), (dict(D=30), "multiple of 4"), (dict(xdtype=torch.float32), "int8"),
    (dict(sdtype=torch.float64), "float32"), (dict(noncontig=True), "contiguous"),
    (dict(N2=99), "shape mismatch"), (dict(offset=1), "aligned"),
])
def test_int8_kernel_input_checks(bad, err):
    D = bad.get("D", 64)
    qv = torch.zeros((4, D), dtype=torch.int8)
    xv = torch.zeros((100, D), dtype=bad.get("xdtype", torch.int8))
    if bad.get("noncontig"):
        xv = torch.zeros((D, 100), dtype=torch.int8).T
    if bad.get("offset"):
        xv = torch.zeros(100 * D + 1, dtype=torch.int8)[1:].view(100, D)
    qs = torch.ones(4)
    xs = torch.ones(bad.get("N2", 100), dtype=bad.get("sdtype", torch.float32))
    bias = torch.zeros(100)
    with pytest.raises(ValueError, match=err):
        tq._check(qv, qs, xv, xs, bias, bad.get("k", 10))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the K5/K6/K7 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_int8_kernels_match_plain_on_card(cuda_device):
    rng = np.random.default_rng(1)
    case = _int8_case(rng, 70, 5000, 768)
    tc = [t.to(cuda_device) for t in _t(*case)]
    for fn, B in ((tq.streaming_topk_int8_cuda, 3), (tq.streaming_topk_int8_cuda_qmajor, 70),
                  (tq.streaming_topk_int8_cuda_qres, 70)):
        sub = [tc[0][:B].contiguous(), tc[1][:B].contiguous(), *tc[2:]]
        for k in (1, 100, 300):
            ks, ki = fn(*sub, k)
            ps, pi = tq.streaming_topk_int8(*sub, k)
            np.testing.assert_array_equal(ks.cpu().numpy(), ps.cpu().numpy())
            _assert_int8_equiv(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(),
                               [case[0][:B], case[1][:B], *case[2:]])


@pytest.mark.parametrize("D,offset,want", [(64, 0, 1), (36, 0, 0), (64, 4, 0), (768, 0, 1)])
def test_tensor_core_staging_width(D, offset, want):
    """K6/K7 stage 16-byte pieces only where D % 16 == 0 and both row
    matrices are 16-byte aligned, and 32-bit words otherwise."""
    xv = torch.zeros(100 * D + 16, dtype=torch.int8)[offset: offset + 100 * D].view(100, D)
    qv = torch.zeros((3, D), dtype=torch.int8)
    assert xv.data_ptr() % 16 == offset % 16 and qv.data_ptr() % 16 == 0
    assert tq._vec16(qv, xv) == want

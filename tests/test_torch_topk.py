"""The port's top-k (`codegraph_tpu_torch.ops.topk`) held to the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it on the CPU: the XLA `streaming_topk`,
`exact_topk`, and the Pallas kernels K1/K2 in interpret mode. The port's
K1/K2 wrappers get CPU tensors here, so they run their plain version; the
CUDA kernels themselves are held to it on the card (`chip_smoke.py`, and
`test_kernels_match_plain_on_card` below where a GPU is present).

Tolerances: f32 scores within 1e-5 absolute, because the two packages sum
the dot products in another order (unit-norm rows give scores in [-1, 1]).
A bf16 corpus with bf16 queries multiplies exactly in f32, so the same
bound holds there. Ids must be equal except where the scores tie within
that tolerance.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.ops import topk as jtopk
from codegraph_tpu_torch.ops import similarity as tsim
from codegraph_tpu_torch.ops import topk as ttopk
from codegraph_tpu_torch.core.padding import combine_bias

TOL = 1e-5


def _unit(a):
    n = np.linalg.norm(a, axis=1, keepdims=True)
    return (a / np.maximum(n, 1e-6)).astype(np.float32)


def assert_topk_equiv(s, i, ref_s, ref_i, q, x, bias, tol=TOL):
    """Scores equal within tol, sentinels at the same places, and an id that
    differs from the reference's only where its true score ties."""
    s, i = np.asarray(s, np.float64), np.asarray(i)
    ref_s, ref_i = np.asarray(ref_s, np.float64), np.asarray(ref_i)
    live = ref_s > ttopk.NEG_INF / 2
    assert np.array_equal(s > ttopk.NEG_INF / 2, live)
    np.testing.assert_allclose(s[live], ref_s[live], rtol=0, atol=tol)
    true = (np.asarray(q, np.float64) @ np.asarray(x, np.float64).T
            + np.asarray(bias, np.float64)[None, :])
    for b, p in zip(*np.nonzero((i != ref_i) & live)):
        assert abs(true[b, i[b, p]] - ref_s[b, p]) <= tol, (b, p, i[b, p], ref_i[b, p])
    for b in range(i.shape[0]):
        ids = i[b][live[b]]
        assert len(set(ids.tolist())) == ids.size


def _case(rng, B, N, D, dead_frac=0.0):
    q = _unit(rng.standard_normal((B, D)))
    x = _unit(rng.standard_normal((N, D)))
    bias = np.zeros(N, np.float32)
    if dead_frac:
        bias[rng.choice(N, size=max(1, int(N * dead_frac)), replace=False)] = ttopk.NEG_INF
    return q, x, bias


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,N,D,k,tile_n", [
    (4, 512, 64, 10, 128),
    (3, 1024, 384, 30, 256),
    (40, 768, 768, 100, 256),
])
def test_streaming_topk_matches_jax_xla(rng, B, N, D, k, tile_n):
    q, x, bias = _case(rng, B, N, D, dead_frac=0.01)
    js, ji = jtopk.streaming_topk(q, x, bias, k, tile_n=tile_n)
    ts, ti = ttopk.streaming_topk(*_t(q, x, bias), k, tile_n=tile_n)
    assert ts.dtype == torch.float32 and ti.dtype == torch.int32
    assert_topk_equiv(ts, ti, js, ji, q, x, bias)


@pytest.mark.parametrize("N,tile_n", [(1000, 128), (300, 1024), (1, 64)])
def test_streaming_topk_ragged_n_matches_exact(rng, N, tile_n):
    """The port's plain version takes any N (the JAX one needs N % tile_n
    == 0); the JAX exact_topk is the oracle."""
    q, x, bias = _case(rng, 3, N, 64)
    k = min(7, N)
    js, ji = jtopk.exact_topk(q, x, k, bias)
    ts, ti = ttopk.streaming_topk(*_t(q, x, bias), k, tile_n=tile_n)
    assert_topk_equiv(ts, ti, js, ji, q, x, bias)


def test_exact_topk_matches_jax(rng):
    q, x, bias = _case(rng, 5, 200, 32, dead_frac=0.05)
    js, ji = jtopk.exact_topk(q, x, 9, bias)
    ts, ti = ttopk.exact_topk(*_t(q, x), 9, torch.from_numpy(bias))
    assert_topk_equiv(ts, ti, js, ji, q, x, bias)


def test_merge_topk_matches_jax(rng):
    s_a = -np.sort(-rng.standard_normal((4, 6)).astype(np.float32), axis=1)
    s_b = -np.sort(-rng.standard_normal((4, 6)).astype(np.float32), axis=1)
    i_a = rng.integers(0, 100, (4, 6)).astype(np.int32)
    i_b = rng.integers(100, 200, (4, 6)).astype(np.int32)
    js, ji = jtopk.merge_topk(s_a, i_a, s_b, i_b, 5)
    ts, ti = ttopk.merge_topk(*_t(s_a, i_a, s_b, i_b), 5)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,B,k", [("K1", 5, 10), ("K1", 8, 30), ("K2", 64, 10), ("K2", 64, 100)])
def test_kernel_wrappers_match_jax_pallas(rng, dtype, kernel, B, k):
    """K1/K2 wrappers (plain path on CPU tensors) vs the Pallas kernels in
    interpret mode, with tombstones, on the same f32 or bf16 inputs."""
    N, D = 512, 64
    q, x, bias = _case(rng, B, N, D, dead_frac=0.01)
    jfn, tfn, tile_b = {
        "K1": (jtopk.streaming_topk_pallas, ttopk.streaming_topk_cuda, 8),
        "K2": (jtopk.streaming_topk_pallas_qmajor, ttopk.streaming_topk_cuda_qmajor, 64),
    }[kernel]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    qpad = np.zeros((-(-B // tile_b) * tile_b, D), np.float32)
    qpad[:B] = q  # the Pallas kernels take whole query tiles
    js, ji = jfn(jnp.asarray(qpad, jd), jnp.asarray(x, jd), jnp.asarray(bias), k,
                 tile_n=256, tile_b=tile_b, interpret=True)
    js, ji = np.asarray(js)[:B], np.asarray(ji)[:B]
    td = getattr(torch, dtype)
    tq, tx, tb = _t(q, x, bias)
    ts, ti = tfn(tq.to(td), tx.to(td), tb, k)
    qr = tq.to(td).float().numpy()
    xr = tx.to(td).float().numpy()
    assert_topk_equiv(ts, ti, js, ji, qr, xr, bias)


def test_same_lane_position_collisions_match_jax(rng):
    """tests/test_topk.py:147's adversarial case: several top-k entries
    share a 128-lane position inside one tile."""
    N, D, B, k = 1024, 64, 8, 8
    q = _unit(rng.standard_normal((B, D)))
    x = 0.001 * rng.standard_normal((N, D)).astype(np.float32)
    mults = [10.0, 9.5, 9.0, 8.5, 8.0, 7.5, 7.0, 6.5]
    for b in range(B):
        for j, mult in enumerate(mults):
            x[(j * 128 + b) % N] += mult * q[b]
    bias = np.zeros(N, np.float32)
    js, ji = jtopk.streaming_topk_pallas(q, x, bias, k, tile_n=256, tile_b=8, interpret=True)
    for fn in (ttopk.streaming_topk_cuda, ttopk.streaming_topk_cuda_qmajor):
        ts, ti = fn(*_t(q, x, bias), k, tile_n=256)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-4)


def test_underfilled_rows_match_jax(rng):
    """tests/test_topk.py:175: fewer live rows than k -> (NEG_INF, -1) pad."""
    N, D, B, k = 256, 32, 8, 10
    q = rng.standard_normal((B, D)).astype(np.float32)
    x = rng.standard_normal((N, D)).astype(np.float32)
    bias = np.full(N, ttopk.NEG_INF, np.float32)
    live = [3, 40, 200]
    bias[live] = 0.0
    js, ji = jtopk.streaming_topk_pallas(q, x, bias, k, tile_n=128, tile_b=8, interpret=True)
    ts, ti = ttopk.streaming_topk_cuda(*_t(q, x, bias), k, tile_n=128)
    ti = ti.numpy()
    assert set(ti[:, :3].ravel()) <= set(live)
    assert (ti[:, 3:] == -1).all()
    assert (ts.numpy()[:, 3:] == np.float32(ttopk.NEG_INF)).all()
    np.testing.assert_array_equal(ti[:, :3], np.asarray(ji)[:, :3])


def test_neg_inf_filter_bias_and_k_above_n(rng):
    """A NEG_INF filter on top of a tombstone (-2e30) never enters, and k
    above N pads with (NEG_INF, -1)."""
    q, x, bias = _case(rng, 4, 50, 16)
    bias[:10] = ttopk.NEG_INF
    bias[5:20] += ttopk.NEG_INF
    ts, ti = ttopk.streaming_topk_cuda_qmajor(*_t(q, x, bias), 80, tile_n=16)
    ti = ti.numpy()
    assert not np.isin(ti, np.arange(20)).any()
    assert (ti[:, :30] >= 20).all() and (ti[:, 30:] == -1).all()
    js, ji = jtopk.exact_topk(q, x, 30, bias)
    assert_topk_equiv(ts[:, :30], ti[:, :30], js, ji, q, x, bias)


def test_ties_lower_row_id_wins(rng):
    """Duplicate rows score identically; the lower row id comes first,
    across tiles too."""
    q, x, bias = _case(rng, 2, 64, 16)
    x[40] = x[3]
    x[63] = x[3]
    q[0] = x[3]
    ts, ti = ttopk.streaming_topk_cuda(*_t(q, x, bias), 3, tile_n=16)
    assert ti.numpy()[0].tolist() == [3, 40, 63]


@pytest.mark.parametrize("B,N,layout,tile_b", [
    (1, 1_000_000, ttopk.K1_LAYOUT, 1), (1024, 1_000_000, ttopk.K2_LAYOUT, 32),
    (5, 200, ttopk.K1_LAYOUT, 8), (96, 100003, ttopk.K2_LAYOUT, 64),
    (1, 1, ttopk.K1_LAYOUT, 1), (3000, 5120, ttopk.K2_LAYOUT, 64),
])
def test_kernel_plan_covers_corpus(B, N, layout, tile_b):
    """The split plan handed to the CUDA kernel: whole corpus tiles per
    split, every row covered, no empty split, about TARGET_BLOCKS blocks."""
    splits, rows = ttopk._plan(B, N, layout, tile_b)
    tile_n, target = ttopk.CORPUS_TILE[layout], ttopk.TARGET_BLOCKS[layout]
    assert rows % tile_n == 0
    assert splits * rows >= N and (splits - 1) * rows < N
    b_tiles = -(-B // tile_b)
    n_tiles = -(-N // tile_n)
    assert splits * b_tiles <= max(b_tiles, target + b_tiles)
    assert splits >= min(n_tiles, target // b_tiles) // 2


@pytest.mark.parametrize("B,tm", [(1, 1), (2, 2), (3, 4), (5, 8), (8, 8), (31, 8)])
def test_k1_query_tile(B, tm):
    assert ttopk.k1_tm(B) == tm


@pytest.mark.parametrize("bad,err", [
    (dict(k=0), "k=0"), (dict(k=ttopk.MAX_K + 1), "k="),
    (dict(qdtype=torch.float16), "q must be"), (dict(bias_dtype=torch.float64), "bias must"),
    (dict(D2=32), "shape mismatch"), (dict(noncontig=True), "contiguous"),
    (dict(D=60), "multiple of 8"), (dict(offset=1), "aligned"),
])
def test_kernel_input_checks(bad, err):
    D = bad.get("D", 64)
    q = torch.zeros((4, D), dtype=bad.get("qdtype", torch.float32))
    x = torch.zeros((100, bad.get("D2", D)))
    if bad.get("noncontig"):
        x = torch.zeros((D, 100)).T
    if bad.get("offset"):
        x = torch.zeros(100 * D + 1)[1:].view(100, D)
    bias = torch.zeros(100, dtype=bad.get("bias_dtype", torch.float32))
    with pytest.raises(ValueError, match=err):
        ttopk._check(q, x, bias, bad.get("k", 10))


def test_kernel_wrapper_rejects_mixed_devices():
    q = torch.zeros((2, 8))
    x = torch.zeros((16, 8), device="meta")
    with pytest.raises(ValueError, match="share one"):
        ttopk.streaming_topk_cuda(q, x, torch.zeros(16), 3)


def test_l2_normalize_and_pairwise_match_jax(rng):
    from codegraph_tpu.ops import similarity as jsim

    a = rng.standard_normal((6, 48)).astype(np.float32)
    a[2] = 0.0  # zero rows stay zero
    np.testing.assert_allclose(tsim.l2_normalize(torch.from_numpy(a)).numpy(),
                               np.asarray(jsim.l2_normalize(a)), rtol=1e-6, atol=1e-7)
    assert (tsim.l2_normalize(torch.from_numpy(a)).numpy()[2] == 0).all()
    b = rng.standard_normal((9, 48)).astype(np.float32)
    np.testing.assert_allclose(tsim.pairwise_scores(*_t(a, b)).numpy(),
                               np.asarray(jsim.pairwise_scores(a, b)), rtol=1e-5, atol=1e-5)


def test_combine_bias_matches_jax(rng):
    from codegraph_tpu.core.padding import combine_bias as jcombine

    base = np.where(rng.random(32) < 0.2, ttopk.NEG_INF, 0.0).astype(np.float32)
    extra = np.where(rng.random(20) < 0.3, ttopk.NEG_INF, 0.0).astype(np.float32)
    got = combine_bias(torch.from_numpy(base), extra, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcombine(jnp.asarray(base), extra, 32)))
    assert combine_bias(torch.from_numpy(base), None, 32) is not None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the K1/K2 kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(cuda_device, dtype):
    rng = np.random.default_rng(1)
    q, x, bias = _case(rng, 70, 5000, 768, dead_frac=0.01)
    td = getattr(torch, dtype)
    tq, tx, tb = (t.to(cuda_device) for t in _t(q, x, bias))
    tq, tx = tq.to(td), tx.to(td)
    for fn, B in ((ttopk.streaming_topk_cuda, 3), (ttopk.streaming_topk_cuda_qmajor, 70)):
        for k in (1, 30, 300):
            ks, ki = fn(tq[:B].contiguous(), tx, tb, k)
            ps, pi = ttopk.streaming_topk(tq[:B], tx, tb, k)
            assert_topk_equiv(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(),
                              tq[:B].float().cpu().numpy(), tx.float().cpu().numpy(), bias)


def test_kernel_build_refuses_without_nvcc(monkeypatch, tmp_path):
    """No nvcc, no kernel: the build raises; nothing falls back."""
    import shutil

    from codegraph_tpu_torch.ops import cuda_build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("flat_topk")
    assert not (tmp_path / "build").exists()

"""The port's int8 ops (`codegraph_tpu_torch.ops.quantize`) held to the JAX
package.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it on the CPU: the XLA
`streaming_topk_int8` and the Pallas kernels K5/K6/K7 in interpret mode.
The port's K5/K6/K7 wrappers get CPU tensors here, so they run their plain
version; the CUDA kernel itself is held to it on the card (`chip_smoke.py`,
and `tests/test_torch_card.py` where a GPU is present).

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
    ("K6r", 32, 10), ("K6r", 40, 300),
    ("K5r", 1, 10), ("K5r", 5, 300), ("K5r", 8, 100),
])
def test_int8_wrappers_match_jax_pallas(rng, kernel, B, k):
    """K5/K6/K7 wrappers, the ragged one that K6/K7 hand the corpora TMA
    cannot read (K6r, at D = 100, a width TMA cannot read) and the one
    that K5 hands rows that are not 4-byte aligned (K5r, at D = 101: rows
    begin at every byte of a word); plain path on CPU tensors, vs the
    Pallas kernels in interpret mode, with tombstones and a zero row."""
    N, D = 1024, {"K6r": 100, "K5r": 101}.get(kernel, 64)
    case = _int8_case(rng, B, N, D)
    jfn, tfn, tile_b = {
        "K5": (jq.streaming_topk_int8_pallas, tq.streaming_topk_int8_cuda, 8),
        "K5r": (jq.streaming_topk_int8_pallas, tq.streaming_topk_int8_cuda_realigned, 8),
        "K6": (jq.streaming_topk_int8_qmajor, tq.streaming_topk_int8_cuda_qmajor, 16),
        "K7": (jq.streaming_topk_int8_qres, tq.streaming_topk_int8_cuda_qres, 16),
        "K6r": (jq.streaming_topk_int8_qmajor, tq.streaming_topk_int8_cuda_ragged, 16),
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
    (dict(k=0), "k=0"), (dict(D=30), "route: bytes"), (dict(xdtype=torch.float32), "int8"),
    (dict(sdtype=torch.float64), "float32"), (dict(noncontig=True), "contiguous"),
    (dict(N2=99), "shape mismatch"), (dict(offset=1), "route: bytes"),
])
def test_int8_kernel_input_checks(bad, err):
    """Contract breaches raise; a width that is not a multiple of 4 (the
    rule before every width ran on the card) or a base one byte in is no
    breach: K5 reads such rows as realigned words (K5r) and K6/K7 through
    the ragged producer (K6r)."""
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
    if err.startswith("route: "):
        tq._check(qv, qs, xv, xs, bias, bad.get("k", 10))
        assert tq.int8_route("K5", qv, xv, xs, bias) == err[len("route: "):]
        assert tq.int8_route("K6", qv, xv, xs, bias) == "ragged, bytes"
        return
    with pytest.raises(ValueError, match=err):
        tq._check(qv, qs, xv, xs, bias, bad.get("k", 10))


@pytest.mark.parametrize("D,offset,xs_offset,want", [
    (64, 0, 0, True), (36, 0, 0, False), (64, 4, 0, False), (768, 0, 0, True),
    (100, 0, 0, False), (784, 0, 0, True), (768, 8, 0, False), (16, 0, 0, True),
    (768, 0, 1, False), (768, 0, 2, False), (768, 0, 4, True),
])
def test_tensor_core_staging_width(D, offset, xs_offset, want):
    """K6/K7 run on TMA-fed wgmma only where D % 16 == 0 and both row
    matrices and the corpus scales and bias are 16-byte aligned (TMA's
    stride and address rule); every other shape goes to the same kernel
    fed by the ragged-row producer (K6r)."""
    xv = torch.zeros(100 * D + 16, dtype=torch.int8)[offset: offset + 100 * D].view(100, D)
    qv = torch.zeros((3, D), dtype=torch.int8)
    xs = torch.zeros(104)[xs_offset: xs_offset + 100]
    bias = torch.zeros(100)
    assert xv.data_ptr() % 16 == offset % 16 and qv.data_ptr() % 16 == 0
    assert xs.data_ptr() % 16 == 4 * xs_offset % 16 and bias.data_ptr() % 16 == 0
    assert tq.tma_shape(qv, xv, xs, bias) is want
    assert (tq.int8_route("K6", qv, xv, xs, bias) == "tma") is want


#: the route of each width's int8 rows at a 16-byte aligned base: K5's
#: words or realigned bytes, K6/K7's TMA or the ragged producer's widest
#: aligned copy (D = 768, a multiple of 16, beside the widths of the flat
#: route test)
INT8_ROUTES = {
    1: ("bytes", "ragged, bytes"), 3: ("bytes", "ragged, bytes"), 25: ("bytes", "ragged, bytes"),
    50: ("bytes", "ragged, bytes"), 60: ("4-byte pieces", "ragged, 4-byte pieces"),
    100: ("4-byte pieces", "ragged, 4-byte pieces"), 300: ("4-byte pieces", "ragged, 4-byte pieces"),
    764: ("4-byte pieces", "ragged, 4-byte pieces"), 765: ("bytes", "ragged, bytes"),
    768: ("4-byte pieces", "tma"), 1000: ("4-byte pieces", "ragged, 8-byte pieces"),
}


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("D", sorted(INT8_ROUTES))
def test_every_int8_width_and_base_takes_a_route(D, offset):
    """No int8 width or base raises: `_check` takes it, and `int8_route`
    names the route of K5 and of K6/K7; a base one byte in is read as
    realigned words by both."""
    buf = torch.zeros(40 * D + 80, dtype=torch.int8)
    skip = -buf.data_ptr() % 64
    xv = buf[skip + offset: skip + offset + 40 * D].view(40, D)
    qv = torch.zeros((3, D), dtype=torch.int8)
    xs, bias = torch.ones(40), torch.zeros(40)
    tq._check(qv, torch.ones(3), xv, xs, bias, 10)
    k5, k6 = ("bytes", "ragged, bytes") if offset else INT8_ROUTES[D]
    assert tq.int8_route("K5", qv, xv, xs, bias) == k5
    assert tq.int8_route("K6", qv, xv, xs, bias) == tq.int8_route("K7", qv, xv, xs, bias) == k6


@pytest.mark.parametrize("B,tile", [
    (1, 64), (32, 64), (33, 64), (63, 64), (64, 64), (65, 128), (128, 128), (129, 128),
    (255, 128), (256, 128), (1000, 128), (1024, 128),
])
def test_tc_plan_tile_by_batch(B, tile):
    """A batch of at most 64 takes one 64-row query tile (one consumer
    warpgroup), larger batches 128-row tiles (two); every query row is in a
    block and no block holds padding only; at D=768 the query tile stays
    resident beside 6 ring stages."""
    plan = tq.tc_plan(B, 10_000_000, 768, 100)
    assert plan.query_tile == tile
    assert plan.grid_x == -(-B // tile) and (plan.grid_x - 1) * tile < B
    assert plan.resident and plan.stages == 6


@pytest.mark.parametrize("D", [16, 64, 768, 784, 1024, 1152, 1536, 4096, 16384])
@pytest.mark.parametrize("B", [64, 1024])
def test_tc_plan_smem_fits_and_ignores_k(B, D):
    """For k = 1..1024 a block's shared memory is the same and within the
    232,448 bytes a block may have on an H100; the query tile stays
    resident with the most ring stages that fit (at D <= 1,152 with 128
    rows, 2,304 with 64), else it streams with the corpus through the most
    that fit."""
    plans = [tq.tc_plan(B, 1_000_000, D, k) for k in (1, 2, 100, 300, 1023, 1024)]
    assert len({(p.smem, p.resident, p.stages, p.query_tile) for p in plans}) == 1
    plan = plans[0]
    assert plan.smem <= tq.SMEM_PER_BLOCK
    assert plan.smem == tq.tc_smem(plan.query_tile, plan.resident, plan.stages, D)
    fits = {(res, n): tq.tc_smem(plan.query_tile, res, n, D) <= tq.SMEM_PER_BLOCK
            for res in (True, False) for n in tq.TC_STAGES}
    assert (plan.resident, plan.stages) == next(key for key in fits if fits[key])
    assert plan.resident == (D <= (1152 if plan.query_tile == 128 else 2304))
    assert plan.stages >= 3


@pytest.mark.parametrize("B,N", [(33, 1), (64, 200), (70, 100003), (256, 131072),
                                 (1000, 1_000_000), (1024, 10_000_000), (3000, 5120),
                                 (64, 10_000_000)])
def test_tc_plan_covers_corpus(B, N):
    """Whole corpus tiles per split, every row covered, no empty split, and
    one wave of at most one block per SM (TC_SMS) unless the query tiles
    alone exceed it; the card's SM count sets the wave."""
    for sms in (tq.TC_SMS, 114):
        plan = tq.tc_plan(B, N, 768, 30, sms=sms)
        assert plan.rows_per_split % tq.TC_TILE_N == 0
        assert plan.splits * plan.rows_per_split >= N
        assert (plan.splits - 1) * plan.rows_per_split < N
        n_tiles = -(-N // tq.TC_TILE_N)
        assert plan.splits * plan.grid_x <= max(plan.grid_x, sms)
        assert plan.splits >= min(n_tiles, sms // plan.grid_x) // 2


@pytest.mark.parametrize("B,N,k", [(33, 1, 1), (64, 300, 30), (1024, 10_000_000, 300),
                                   (70, 5000, 1024), (129, 200, 10)])
def test_tc_plan_scratch_entries(B, N, k):
    """The scratch holds the per-split lists [B, S, k] and the first merge
    level (one split writes straight to the output), the bounds [B, S],
    and a candidate buffer of TC_BUF_CAP entries for each of a block's 128
    rows."""
    plan = tq.tc_plan(B, N, 768, k)
    S, G = plan.splits, tq.MERGE_GROUP
    want = 0 if S == 1 else B * k * (S + -(-S // G))
    assert plan.work_entries == want
    assert S == 1 or plan.work_entries >= B * S * k
    assert plan.bound_entries == B * S
    assert plan.cand_entries == plan.grid_x * plan.splits * 128 * (tq.ROW_CAP + 128)


def _variants_tool():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                        "int8_topk_variants.py")
    spec = importlib.util.spec_from_file_location("int8_topk_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("table,name", [
    *(pytest.param("VARIANTS", n, id=n) for n in _variants_tool().VARIANTS),
    *(pytest.param("RAGGED_K5_VARIANTS", n, id=f"ragged-k5: {n}")
      for n in _variants_tool().RAGGED_K5_VARIANTS),
])
def test_int8_variant_tool_anchors_in_source(table, name):
    """Every text change of tools/int8_topk_variants.py (its K6 table, and
    --ragged-k5's table of K5r) applies exactly once to its sources
    (csrc/int8_topk.cu, csrc/topk_merge.cuh, and csrc/hopper_tc.cuh for the
    ragged producer's), and every constant it sets exists in ops/topk.py,
    whose tensor-core plan K6/K7 share."""
    from codegraph_tpu_torch.ops import cuda_build
    from codegraph_tpu_torch.ops import topk as ttopk

    srcs = [(cuda_build.CSRC_DIR / f).read_text() for f in _variants_tool().SOURCES]
    subs, consts, _ = getattr(_variants_tool(), table)[name]
    for anchor, _ in subs:
        assert sum(src.count(anchor) for src in srcs) == 1, anchor
    for const in consts:
        assert hasattr(ttopk, const)

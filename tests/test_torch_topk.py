"""The port's top-k (`codegraph_tpu_torch.ops.topk`) held to the JAX package.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs as its own tests run it on the CPU: the XLA `streaming_topk`,
`exact_topk`, and the Pallas kernels K1/K2 in interpret mode. The port's
K1/K2 wrappers get CPU tensors here, so they run their plain version; the
CUDA kernels themselves are held to it on the card (`chip_smoke.py`, and
`tests/test_torch_card.py` where a GPU is present).

Tolerances: f32 scores within 1e-5 absolute, because the two packages sum
the dot products in another order (unit-norm rows give scores in [-1, 1]).
A bf16 corpus with bf16 queries multiplies exactly in f32, so the same
bound holds there. Ids must be equal except where the scores tie within
that tolerance.
"""

import dataclasses
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


def assert_topk_equiv(s, i, ref_s, ref_i, q, x, bias, tol=TOL, true=None):
    """Scores equal within tol, sentinels at the same places, and an id that
    differs from the reference's only where its true score ties. `true`
    ([B, N] scores) replaces q @ x.T + bias as the judge of a tie."""
    s, i = np.asarray(s, np.float64), np.asarray(i)
    ref_s, ref_i = np.asarray(ref_s, np.float64), np.asarray(ref_i)
    live = ref_s > ttopk.NEG_INF / 2
    assert np.array_equal(s > ttopk.NEG_INF / 2, live)
    np.testing.assert_allclose(s[live], ref_s[live], rtol=0, atol=tol)
    if true is None:
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
@pytest.mark.parametrize("kernel,B,k", [("K1", 5, 10), ("K1", 8, 30), ("K2", 64, 10),
                                        ("K2", 64, 100), ("K3", 64, 10), ("K3", 40, 100)])
def test_kernel_wrappers_match_jax_pallas(rng, dtype, kernel, B, k):
    """K1/K2/K3 wrappers (plain path on CPU tensors) vs the Pallas kernels
    in interpret mode, with tombstones, on the same f32 or bf16 inputs."""
    N, D = 512, 64
    q, x, bias = _case(rng, B, N, D, dead_frac=0.01)
    jfn, tfn, tile_b = {
        "K1": (jtopk.streaming_topk_pallas, ttopk.streaming_topk_cuda, 8),
        "K2": (jtopk.streaming_topk_pallas_qmajor, ttopk.streaming_topk_cuda_qmajor, 64),
        "K3": (jtopk.streaming_topk_pallas_qres, ttopk.streaming_topk_cuda_qres, 16),
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
    for fn in (ttopk.streaming_topk_cuda, ttopk.streaming_topk_cuda_qmajor,
               ttopk.streaming_topk_cuda_qres):
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
    (1024, 10_000_000, ttopk.K3_LAYOUT, 32), (256, 5120, ttopk.K3_LAYOUT, 16),
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
    (dict(D=60), "route: 16-byte pieces"), (dict(offset=1), "route: 4-byte pieces"),
])
def test_kernel_input_checks(bad, err):
    """Contract breaches raise; a width that is not a multiple of 8 (the
    rule before any width ran on the card) or a base one element in is no
    breach: the rows take a route (f32 rows: 16-byte pieces at D % 4 == 0,
    else 4-byte ones)."""
    D = bad.get("D", 64)
    q = torch.zeros((4, D), dtype=bad.get("qdtype", torch.float32))
    x = torch.zeros((100, bad.get("D2", D)))
    if bad.get("noncontig"):
        x = torch.zeros((D, 100)).T
    if bad.get("offset"):
        x = torch.zeros(100 * D + 1)[1:].view(100, D)
    bias = torch.zeros(100, dtype=bad.get("bias_dtype", torch.float32))
    if err.startswith("route: "):
        ttopk._check(q, x, bias, bad.get("k", 10))
        assert ttopk.flat_route(x) == err[len("route: "):]
        return
    with pytest.raises(ValueError, match=err):
        ttopk._check(q, x, bias, bad.get("k", 10))


#: the widths of the route tests: not a multiple of 16, 8 or 4 bytes a row
#: as bf16, f32 and int8 rows, and widths users configure (100, 300, 1000)
RAGGED_WIDTHS = (1, 3, 25, 50, 60, 100, 300, 764, 765, 1000)
#: (bf16 route, f32 route) of each width at a 16-byte aligned base: TMA
#: needs rows of a multiple of 16 bytes; the ragged producer copies the
#: widest piece the row stride allows, else realigns words; f32 rows take
#: 16-byte pieces at D % 4 == 0, else 4-byte ones
FLAT_ROUTES = {
    1: ("ragged, bytes", "4-byte pieces"), 3: ("ragged, bytes", "4-byte pieces"),
    25: ("ragged, bytes", "4-byte pieces"), 50: ("ragged, 4-byte pieces", "4-byte pieces"),
    60: ("ragged, 8-byte pieces", "16-byte pieces"),
    100: ("ragged, 8-byte pieces", "16-byte pieces"),
    300: ("ragged, 8-byte pieces", "16-byte pieces"),
    764: ("ragged, 8-byte pieces", "16-byte pieces"), 765: ("ragged, bytes", "4-byte pieces"),
    1000: ("tma", "16-byte pieces"),
}


def _at_offset(N, D, dtype, offset):
    """An [N, D] tensor of `dtype` whose base lies `offset` elements into a
    64-byte aligned storage."""
    buf = torch.zeros(N * D + offset + 64, dtype=dtype)
    skip = (-buf.data_ptr() % 64) // buf.element_size()
    return buf[skip + offset: skip + offset + N * D].view(N, D)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("D", RAGGED_WIDTHS)
def test_every_width_and_base_takes_a_route(D, offset, dtype):
    """No width or base that torch hands over raises: `_check` takes it, and
    `flat_route` names the route K1-K3 read it by (bf16: TMA, or the ragged
    producer's 8- or 4-byte pieces or realigned words; f32: 16- or 4-byte
    pieces). A base one element in takes the narrowest route."""
    td = getattr(torch, dtype)
    x = _at_offset(40, D, td, offset)
    assert x.data_ptr() % 16 == (offset * x.element_size()) % 16
    q = torch.zeros((3, D), dtype=td)
    ttopk._check(q, x, torch.zeros(40), 10)
    bf16_route, f32_route = FLAT_ROUTES[D]
    if offset:
        bf16_route, f32_route = "ragged, bytes", "4-byte pieces"
    assert ttopk.flat_route(x) == (bf16_route if td == torch.bfloat16 else f32_route)
    assert ttopk.uses_tensor_cores(q.dtype, x.dtype) == (td == torch.bfloat16)


@pytest.mark.parametrize("elt", [1, 2])
@pytest.mark.parametrize("D", [1, 100, 765, 1000])
def test_swizzled_box_unswizzles_to_the_rows(D, elt):
    """The stage layout the ragged producer writes (`swizzled_box`, the
    128-byte swizzle of a TMA box) holds exactly the corpus bytes: undoing
    the swizzle (chunk j of row r back from chunk j ^ (r & 7)) gives rows
    n0 .. n0 + 127, bytes c * 128 .. c * 128 + 127, with zeros past the
    row's bytes and past N, for every chunk c of a row; the last tile of a
    ragged N runs past N."""
    rng = np.random.default_rng(D)
    N = 300
    rows = rng.integers(1, 256, (N, D * elt), dtype=np.uint8)
    chunks = -(-D * elt // 128)
    for n0 in (0, 256):
        for c in range(chunks):
            box = ttopk.swizzled_box(rows, n0, c).reshape(128, 8, 16)
            plain = np.stack([box[r, np.arange(8) ^ (r & 7)] for r in range(128)]).reshape(128, 128)
            want = np.zeros((128, 128), np.uint8)
            live = min(128, N - n0)
            width = min(128, D * elt - c * 128)
            want[:live, :width] = rows[n0: n0 + live, c * 128: c * 128 + width]
            np.testing.assert_array_equal(plain, want)
            assert (plain[:, width:] == 0).all() and (plain[live:] == 0).all()
    # the swizzle moves chunks within a row: row r's chunk j is at j ^ (r & 7)
    box = ttopk.swizzled_box(rows, 0, 0).reshape(128, 8, 16)
    for r in (0, 1, 7, 9):
        first = np.zeros(128, np.uint8)
        first[: min(128, D * elt)] = rows[r, :128]
        np.testing.assert_array_equal(box[r, 1 ^ (r & 7)], first[16:32])


@pytest.mark.parametrize("row_bytes,addr,want", [
    (200, 0, 8), (200, 8, 8), (200, 4, 4), (1530, 0, 1), (1536, 0, 16), (1536, 2, 1),
    (100, 0, 4), (765, 0, 1), (1000, 0, 8), (3060, 0, 4), (400, 16, 16), (400, 4, 4),
])
def test_load_piece_is_the_widest_aligned_copy(row_bytes, addr, want):
    """The producer's copy width: the widest of 16, 8 and 4 bytes that the
    row stride and the base both divide, else 1 (realigned words)."""
    assert ttopk.load_piece(row_bytes, addr) == want
    assert ttopk.rows_tma_readable(row_bytes, addr) == (row_bytes % 16 == 0 and addr % 16 == 0)


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





ROW_LAYOUTS = (ttopk.K2_LAYOUT, ttopk.K3_LAYOUT, ttopk.K4_LAYOUT)


@pytest.mark.parametrize("layout", ROW_LAYOUTS)
@pytest.mark.parametrize("k", [1, 30, 300, 1024])
def test_row_plan_tiles_and_stages(layout, k):
    """K2/K3/K4 take one block tile for every k: 128 queries x 128 corpus
    rows, a ring of at least 3 slices of 16 depths. They read f32 rows (an
    f32 xt) only: a bf16 corpus runs on the tensor cores, and a plan for
    2-byte elements is refused."""
    plan = ttopk.row_plan(layout, 1024, 1_000_000, k, 4)
    assert (plan.query_tile, plan.corpus_tile) == (128, 128)
    assert plan.stages >= 3 and plan.depth_step == 16
    assert plan.smem == ttopk.row_smem(layout, 4, 128) == \
        ttopk.row_plan(layout, 1024, 1_000_000, 1, 4).smem
    with pytest.raises(ValueError, match="tensor cores"):
        ttopk.row_plan(layout, 1024, 1_000_000, k, 2)


@pytest.mark.parametrize("layout", ROW_LAYOUTS)
@pytest.mark.parametrize("B,N", [(1, 1), (31, 200), (70, 100003), (256, 131072),
                                 (1000, 1_000_000), (1024, 1_000_000), (3000, 5120),
                                 (1024, 10_000_000)])
def test_row_plan_covers_corpus(layout, B, N):
    """Whole corpus tiles per split, every row covered, no empty split,
    every query row in a block, about TARGET_BLOCKS blocks."""
    plan = ttopk.row_plan(layout, B, N, 30, 4)
    assert plan.rows_per_split % plan.corpus_tile == 0
    assert plan.splits * plan.rows_per_split >= N
    assert (plan.splits - 1) * plan.rows_per_split < N
    b_tiles = -(-B // plan.query_tile)
    assert plan.grid_x == b_tiles  # every query row in a block, no block of padding only
    n_tiles = -(-N // 128)
    target = ttopk.TARGET_BLOCKS[layout]
    assert plan.splits * b_tiles <= max(b_tiles, target + b_tiles)
    assert plan.splits >= min(n_tiles, target // b_tiles) // 2


@pytest.mark.parametrize("B,want", [(1, 32), (31, 32), (32, 32), (33, 64), (64, 64), (65, 128),
                                    (70, 128), (256, 128), (1000, 128), (1024, 128)])
def test_row_query_tile(B, want):
    """The query tile comes from the batch: 32 or 64 rows when the batch
    fits them (QueryService's bucket of 64), else 128. K3 runs K2's schedule,
    so its plan is K2's; K4's differs only in its shared memory."""
    assert ttopk.row_query_tile(B) == want
    k2, k3, k4 = (ttopk.row_plan(layout, B, 100_000, 10, 4) for layout in ROW_LAYOUTS)
    assert k2.query_tile == k3.query_tile == k4.query_tile == want
    assert k3 == dataclasses.replace(k2, layout=ttopk.K3_LAYOUT)
    assert k4 == dataclasses.replace(k2, layout=ttopk.K4_LAYOUT, smem=k4.smem)
    assert k2.smem == ttopk.row_smem(ttopk.K2_LAYOUT, 4, want)


@pytest.mark.parametrize("B,N,k", [(1, 1, 1), (64, 300, 30), (1024, 1_000_000, 300),
                                   (70, 5000, 1024)])
def test_row_plan_scratch_entries(B, N, k):
    """The scratch holds the per-split lists [B, S, k] and the first merge
    level; one split writes straight to the output."""
    plan = ttopk.row_plan(ttopk.K2_LAYOUT, B, N, k, 4)
    S, G = plan.splits, ttopk.MERGE_GROUP
    want = 0 if S == 1 else B * k * (S + -(-S // G))
    assert plan.work_entries == ttopk.work_entries(B, k, S) == want
    assert S == 1 or plan.work_entries >= B * S * k


@pytest.mark.parametrize("layout", ROW_LAYOUTS)
@pytest.mark.parametrize("elt", [4, 2])
def test_row_smem_fits_two_blocks_per_sm(layout, elt):
    """For k = 1..1024 and D = 8..4096 a block's shared memory stays within
    the 232,448 bytes a block may have, and two blocks (with the 1 KB each
    reserves) fit an H100 SM's 228 KB. rows_pass1 reads 4-byte elements
    only: a bf16 corpus (2 bytes) has no row plan, it runs on the tensor
    cores."""
    if elt == 2:
        for tile in (32, 64, 128):
            with pytest.raises(ValueError, match="tensor cores"):
                ttopk.row_smem(layout, elt, tile)
        return
    sizes = {ttopk.row_plan(layout, 1024, 50_000, k, elt).smem for k in (1, 2, 100, 1023, 1024)}
    assert len(sizes) == 1
    smem = sizes.pop()
    assert smem <= ttopk.SMEM_PER_BLOCK
    assert 2 * (smem + 1024) <= 228 * 1024
    for D in (8, 36, 768, 4096):  # no term of the layout depends on D
        assert ttopk.row_smem(layout, elt, 128) == smem
    assert ttopk.row_plan(layout, 32, 50_000, 1024, elt).smem == \
        ttopk.row_smem(layout, elt, 32) < ttopk.row_smem(layout, elt, 64) < smem


def _variants_tool():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                        "flat_topk_variants.py")
    spec = importlib.util.spec_from_file_location("flat_topk_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(_variants_tool().VARIANTS))
def test_variant_tool_anchors_in_source(name):
    """Every text change of tools/flat_topk_variants.py still applies to
    csrc/flat_topk.cu or csrc/topk_merge.cuh, and every ops/topk.py
    constant it sets exists."""
    from codegraph_tpu_torch.ops import cuda_build

    tool = _variants_tool()
    srcs = [(cuda_build.CSRC_DIR / f).read_text() for f in tool.SOURCES]
    subs, consts, _ = tool.VARIANTS[name]
    for anchor, _ in subs:
        assert any(anchor in src for src in srcs)
    for const in consts:
        assert hasattr(ttopk, const)


@pytest.mark.parametrize("name", list(_variants_tool().RAGGED_VARIANTS))
def test_ragged_variant_tool_anchors_in_source(name):
    """Every text change of tools/flat_topk_variants.py's RAGGED_VARIANTS
    (K2r's copies) still applies to csrc/flat_topk.cu, once, so that the
    tool times what it names."""
    from codegraph_tpu_torch.ops import cuda_build

    tool = _variants_tool()
    srcs = [(cuda_build.CSRC_DIR / f).read_text() for f in tool.SOURCES]
    subs, consts, _ = tool.RAGGED_VARIANTS[name]
    for anchor, _ in subs:
        assert [src.count(anchor) for src in srcs if anchor in src][:1] == [1]
    for const in consts:
        assert hasattr(ttopk, const)


@pytest.mark.parametrize("name", list(_variants_tool().K1_VARIANTS))
def test_k1_variant_tool_anchors_in_source(name):
    """Every text change of tools/flat_topk_variants.py's K1_VARIANTS still
    applies to csrc/flat_topk_k1tc.cu or its headers, once, and every
    ops/topk.py constant it sets exists."""
    from codegraph_tpu_torch.ops import cuda_build

    tool = _variants_tool()
    srcs = [(cuda_build.CSRC_DIR / f).read_text() for f in tool.K1_SOURCES]
    subs, consts, _ = tool.K1_VARIANTS[name]
    for anchor, _ in subs:
        assert [src.count(anchor) for src in srcs if anchor in src][:1] == [1]
    for const in consts:
        assert hasattr(ttopk, const)


@pytest.mark.parametrize("table,name", [(t, n) for t in ("RAGGED_K1_VARIANTS", "RAGGED_XT_VARIANTS")
                                         for n in getattr(_variants_tool(), t)])
def test_ragged_k1_and_xt_variant_tool_anchors_in_source(table, name):
    """Every text change of tools/flat_topk_variants.py's RAGGED_K1_VARIANTS
    (K1r's copies) and RAGGED_XT_VARIANTS (K4r's) still applies to
    csrc/flat_topk.cu, once, so that the tool times what it names."""
    from codegraph_tpu_torch.ops import cuda_build

    tool = _variants_tool()
    srcs = [(cuda_build.CSRC_DIR / f).read_text() for f in tool.SOURCES]
    subs, consts, _ = getattr(tool, table)[name]
    for anchor, _ in subs:
        assert [src.count(anchor) for src in srcs if anchor in src][:1] == [1]
    for const in consts:
        assert hasattr(ttopk, const)


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


# ---------------------------------------------------------------------------
# K4: K2 over a pre-transposed corpus xt [D, N]
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,N,k", [(64, 512, 10), (64, 768, 100), (128, 1024, 300)])
def test_k4_wrapper_matches_jax_pallas(rng, dtype, B, N, k):
    """The K4 wrapper (plain path on CPU tensors) vs
    `streaming_topk_pallas_qmajor_xt` in interpret mode on the same xt."""
    D = 64
    q, x, bias = _case(rng, B, N, D, dead_frac=0.01)
    x[7] = x[3]  # an exact tie
    xt = np.ascontiguousarray(x.T)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    js, ji = jtopk.streaming_topk_pallas_qmajor_xt(jnp.asarray(q, jd), jnp.asarray(xt, jd),
                                                   jnp.asarray(bias), k, tile_n=256, tile_b=64,
                                                   interpret=True)
    td = getattr(torch, dtype)
    tq, txt, tb = _t(q, xt, bias)
    ts, ti = ttopk.streaming_topk_cuda_qmajor_xt(tq.to(td), txt.to(td), tb, k)
    assert_topk_equiv(ts, ti, js, ji, tq.to(td).float().numpy(), txt.to(td).float().numpy().T,
                      bias)
    ks, ki = ttopk.streaming_topk_cuda_qmajor(tq.to(td), txt.to(td).T.contiguous(), tb, k)
    assert torch.equal(ks, ts) and torch.equal(ki, ti)  # K2 on xt.T: the same function


def test_k4_ragged_n_and_odd_depth(rng):
    """Any N and D: the JAX kernel needs whole tiles; the port's K4 does not."""
    q, x, bias = _case(rng, 33, 1001, 36, dead_frac=0.02)
    args = _t(q, np.ascontiguousarray(x.T), bias)
    ttopk._check_xt(*args, 50)  # the kernel takes D=36 and N=1001 as they are
    ts, ti = ttopk.streaming_topk_cuda_qmajor_xt(*args, 50)
    es, ei = jtopk.exact_topk(q, x, 50, bias=bias)
    assert_topk_equiv(ts, ti, es, ei, q, x, bias)


#: the xt of the route tests: N odd, N % 4 = 2 and N % 4 = 0 (300; as
#: bf16 rows of 600 bytes, 8-byte pieces)
XT_N = (297, 300, 302, 1001, 5003)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset_bytes", [0, 4])
@pytest.mark.parametrize("N", XT_N)
def test_flat_route_of_xt_follows_n_and_base(N, offset_bytes, dtype):
    """`flat_route` of xt [D, N] names how K4 reads it, from N and the
    base: an f32 xt in 16-byte pieces (K4) only where N % 4 == 0 at a
    16-byte aligned base, else in 4-byte pieces (K4r); a bf16 xt through
    TMA only where N % 8 == 0 at an aligned base, else through the
    ragged-row producer's widest piece (`load_piece` of rows of 2N bytes)
    or realigned words."""
    td = getattr(torch, dtype)
    xt = _at_offset(40, N, td, offset_bytes // torch.empty(0, dtype=td).element_size())
    assert xt.data_ptr() % 16 == offset_bytes
    if td == torch.float32:
        want = "16-byte pieces" if (N, offset_bytes) == (300, 0) else "4-byte pieces"
    else:
        piece = {297: "bytes", 300: "8-byte pieces", 302: "4-byte pieces", 1001: "bytes",
                 5003: "bytes"}[N]
        if offset_bytes and piece == "8-byte pieces":
            piece = "4-byte pieces"
        want = "ragged, " + piece
    assert ttopk.flat_route(xt) == want
    ttopk._check_xt(torch.zeros((3, 40), dtype=td), xt, torch.zeros(N), 10)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("N,k", [(297, 30), (302, 300), (1001, 100), (5003, 10)])
def test_k4r_wrapper_matches_jax_pallas(rng, N, k, offset):
    """The K4 wrapper over an f32 xt that 16-byte pieces cannot read (its
    route K4r; the plain path on CPU tensors), N odd or N % 4 = 2 and a
    base one element in, vs `streaming_topk_pallas_qmajor_xt` in interpret
    mode on the same xt padded with zero columns to whole tiles, whose bias
    is NEG_INF: ids equal outside ties, scores within 1e-5."""
    B, D, tile_n = 64, 64, 256
    q, x, bias = _case(rng, B, N, D, dead_frac=0.01)
    x[N - 1] = x[3]  # an exact tie across tiles
    xt = _at_offset(D, N, torch.float32, offset)
    xt.copy_(torch.from_numpy(np.ascontiguousarray(x.T)))
    assert ttopk.flat_route(xt) == "4-byte pieces"
    tq, tb = _t(q, bias)
    ts, ti = ttopk.streaming_topk_cuda_qmajor_xt(tq, xt, tb, k)
    n_pad = -(-N // tile_n) * tile_n
    xt_pad = np.zeros((D, n_pad), np.float32)
    xt_pad[:, :N] = x.T
    bias_pad = np.full(n_pad, ttopk.NEG_INF, np.float32)
    bias_pad[:N] = bias
    js, ji = jtopk.streaming_topk_pallas_qmajor_xt(jnp.asarray(q), jnp.asarray(xt_pad),
                                                   jnp.asarray(bias_pad), k, tile_n=tile_n,
                                                   tile_b=64, interpret=True)
    assert_topk_equiv(ts, ti, js, ji, q, x, bias)


@pytest.mark.parametrize("bad,err", [
    (dict(k=0), "k=0"), (dict(qdtype=torch.float16), "q must be"),
    (dict(xdtype=torch.float16), "xt must be"), (dict(bias_dtype=torch.float64), "bias must"),
    (dict(D2=32), "shape mismatch"), (dict(noncontig=True), "contiguous"),
])
def test_k4_input_checks(bad, err):
    D = 60  # no multiple-of-8 rule: xt is read one element at a time
    q = torch.zeros((4, D), dtype=bad.get("qdtype", torch.float32))
    xt = torch.zeros((bad.get("D2", D), 100), dtype=bad.get("xdtype", torch.float32))
    if bad.get("noncontig"):
        xt = torch.zeros((100, D)).T
    bias = torch.zeros(100, dtype=bad.get("bias_dtype", torch.float32))
    with pytest.raises(ValueError, match=err):
        ttopk._check_xt(q, xt, bias, bad.get("k", 10))


def test_k4_plan_matches_k2():
    assert ttopk._plan(1024, 1_000_000, ttopk.K4_LAYOUT, 128) == \
        ttopk._plan(1024, 1_000_000, ttopk.K2_LAYOUT, 128)



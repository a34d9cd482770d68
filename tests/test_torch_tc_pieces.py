"""f32 queries over bf16 rows on the tensor cores, and K1 over bf16 rows
("K1tc"): the bf16 split of a query, what the three-piece kernels compute,
and the host plans of K1tc (`k1tc_plan`) and of K2tc with three pieces
(`tc_plan(..., pieces=3)`).

`split_bf16` (`ops/bf16_split.py`) has no counterpart in the JAX package;
it is held to exactness. The three-piece kernels (`bf16_k1_pass1<QN, 3>`,
`bf16_tc_pass1<3>`) run only on a card, so their arithmetic is emulated
here: three bf16 x bf16 products (the smallest piece first, each k16 step
of depth) summed in one f32 accumulator, plus the bias in one f32 add,
then the top-k. The emulation and the wrappers' plain route on CPU tensors
are held to the JAX `streaming_topk` on the same f32 queries and bf16 rows
(inputs made with numpy from a seed): scores within 1e-5 (unit-norm rows,
scores in [-1, 1]; the f32 sums are taken in another order), ids equal
except where the scores tie within that bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from codegraph_tpu.ops import topk as jtopk
from codegraph_tpu_torch.ops import topk as ttopk
from codegraph_tpu_torch.ops.bf16_split import split_bf16
from tests.test_torch_topk import _case, _t, assert_topk_equiv

BF16 = torch.bfloat16


def _exact(t: torch.Tensor) -> bool:
    hi, mid, lo = split_bf16(t.clone())
    return all(p.dtype == BF16 for p in (hi, mid, lo)) and \
        torch.equal(hi.float() + mid.float() + lo.float(), t)


def test_split_bf16_is_exact_on_unit_queries(rng):
    """Unit queries, as the indexes hand them to the kernels, split exactly:
    hi + mid + lo == q bit for bit, each piece bf16."""
    q = torch.from_numpy(_case(rng, 64, 1, 768)[0])
    assert _exact(q)


#: the largest f32 whose hi piece is finite: below half a step (2**119)
#: above bf16's largest finite value, where rounding to bf16 overflows
TOP = float(np.nextafter(np.float32(3.3895313892515355e38 + 2.0 ** 119), np.float32(0)))


@settings(max_examples=300, deadline=None)
@given(st.floats(min_value=2.0 ** -110, max_value=TOP, allow_nan=False,
                 allow_infinity=False, width=32), st.booleans())
def test_split_bf16_is_exact_across_magnitudes(v, negative):
    """Every f32 value from 2**-110 to TOP (3.3961e38), either sign, splits
    exactly."""
    t = torch.tensor([-v if negative else v], dtype=torch.float32)
    assert _exact(t)


@pytest.mark.parametrize("v", [0.0, -0.0, 2.0 ** -110, 3.3895313892515355e38, TOP])
def test_split_bf16_is_exact_at_the_range_ends(v):
    assert _exact(torch.tensor([v], dtype=torch.float32))


@pytest.mark.parametrize("v", [2.0 ** -111 * 1.2345, 1e-38, 1e-45])
def test_split_bf16_loses_bits_below_2_to_the_minus_110(v):
    """Below 2**-110 (and in f32's subnormals) lo's lowest bits fall under
    bf16's smallest subnormal, 2**-133: the pieces no longer sum to t."""
    assert not _exact(torch.tensor([v], dtype=torch.float32))


def test_split_bf16_hi_overflows_past_bf16s_range():
    """From half a step above bf16's largest finite value hi rounds to
    infinity."""
    above = float(np.nextafter(np.float32(TOP), np.float32(np.inf)))
    hi, _, _ = split_bf16(torch.tensor([above, 3.4e38], dtype=torch.float32))
    assert torch.isinf(hi.float()).all()


def _three_piece_topk(q, x, bias, k, step=16):
    """What the three-piece kernels compute, emulated: each f32 query as
    split_bf16's pieces; for each k16 step of depth lo, mid and hi times
    the bf16 rows (exact products) added to one f32 accumulator; the bias
    in one f32 add; then the top-k under the shared order."""
    hi, mid, lo = split_bf16(q.float())
    xf = x.float()
    acc = torch.zeros(q.shape[0], x.shape[0], dtype=torch.float32)
    for d0 in range(0, q.shape[1], step):
        for piece in (lo, mid, hi):
            acc = acc + piece[:, d0: d0 + step].float() @ xf[:, d0: d0 + step].T
    scores = acc + bias[None, :]
    ids = torch.arange(x.shape[0], dtype=torch.int32).expand_as(scores)
    top_s, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top_s[:, :k], torch.gather(ids, -1, pos[:, :k])


@pytest.mark.parametrize("B,N,D,k", [(1, 700, 64, 10), (8, 1000, 200, 30), (40, 513, 768, 100),
                                     (5, 300, 96, 300)])
def test_three_piece_scores_match_jax(rng, B, N, D, k):
    """The emulated three-piece kernel, and the wrappers' route on CPU
    tensors (K1 and K2 over f32 queries and bf16 rows), against the JAX
    streaming_topk on the same f32 queries over the same bf16 rows, with
    duplicate rows (exact ties), tombstones and k above the live rows at
    (5, 300, 96, 300)."""
    q, x, bias = _case(rng, B, N, D, dead_frac=0.01)
    x[100:120] = x[0:20]
    q[0] = x[5]
    if k > 200:
        bias[250:] = ttopk.NEG_INF
    xb = jnp.asarray(x, jnp.bfloat16)
    xn = np.asarray(xb.astype(jnp.float32))  # the bf16 rows' values
    tile = 256
    npad = -(-N // tile) * tile
    js, ji = jtopk.streaming_topk(jnp.asarray(q), jnp.pad(xb, ((0, npad - N), (0, 0))),
                                  jnp.pad(jnp.asarray(bias), (0, npad - N),
                                          constant_values=ttopk.NEG_INF), k, tile_n=tile)
    tq, tx, tb = _t(q, x, bias)
    tx = tx.to(BF16)
    for s, i in (_three_piece_topk(tq, tx, tb, k), ttopk.streaming_topk_cuda(tq, tx, tb, k),
                 ttopk.streaming_topk_cuda_qmajor(tq, tx, tb, k),
                 ttopk.streaming_topk_cuda_tc3(tq, tx, tb, k),
                 ttopk.streaming_topk_cuda_k1tc(tq, tx, tb, k)):
        assert_topk_equiv(s, i, js, ji, q, xn, bias)


@pytest.mark.parametrize("pieces", [1, 3])
@pytest.mark.parametrize("B", [1, 2, 7, 8, 9, 16, 17, 24, 25, 31, 32, 33, 40, 64])
@pytest.mark.parametrize("D", [8, 64, 200, 384, 576, 768, 1024, 1216])
def test_k1tc_plan_fits_and_fills_the_card(B, D, pieces):
    """For every batch, depth, piece count and k: a query tile of the batch
    rounded up to 8 rows (at most 32), shared memory within a block's
    232,448 bytes and the same for every k, at least 3 ring stages, the
    query tile resident where it fits beside 3 stages, whole corpus tiles a
    split covering the corpus, and the blocks one wave of one block per SM
    that fills the 132 SMs."""
    N = 1_000_000
    plans = [ttopk.k1tc_plan(B, N, D, k, pieces) for k in (1, 30, 300, 1024)]
    p = plans[0]
    assert all(q.smem == p.smem and q.splits == p.splits for q in plans)
    assert p.query_tile == min(32, -(-B // 8) * 8) and p.pieces == pieces
    assert p.smem == ttopk.k1tc_smem(p.query_tile, pieces, p.resident, p.stages, D) \
        <= ttopk.SMEM_PER_BLOCK
    assert p.stages >= 3
    fits = ttopk.k1tc_smem(p.query_tile, pieces, True, 3, D) <= ttopk.SMEM_PER_BLOCK
    assert p.resident == fits
    assert p.rows_per_split % ttopk.TC_TILE_N == 0
    assert p.splits * p.rows_per_split >= N > (p.splits - 1) * p.rows_per_split
    assert p.grid_x == -(-B // p.query_tile)
    blocks = p.grid_x * p.splits
    assert blocks <= ttopk.TC_SMS  # one wave
    assert blocks > ttopk.TC_SMS - p.grid_x - p.splits  # that fills the card
    assert p.bound_entries == B * p.splits
    assert all(q.work_entries == ttopk.work_entries(B, q_k, p.splits)
               for q, q_k in zip(plans, (1, 30, 300, 1024)))


def test_k1tc_smem_is_the_layout_sum():
    """k1tc_smem spells out csrc/flat_topk_k1tc.cu's K1Layout: at D = 768 an
    8-row tile of one piece resident (12 boxes of 1 KB) beside 8 stages of
    16 KB, and a 32-row tile of three pieces streamed (each stage 16 KB of
    corpus and 3 x 4 KB of query) through 6."""
    assert ttopk.k1tc_smem(8, 1, True, 8, 768) == \
        1024 + 8 * 16384 + 12 * 1024 + 4 * 512 + 8 * 160 * 8 + 8 * 20 + 25 * 8 == 157_032
    assert ttopk.k1tc_smem(32, 3, False, 6, 768) == \
        1024 + 6 * (16384 + 3 * 4096) + 4 * 512 + 32 * 160 * 8 + 32 * 20 + 21 * 8


@pytest.mark.parametrize("B", [32, 33, 64, 65, 128, 129, 256, 1000, 1024, 4096])
@pytest.mark.parametrize("D", [64, 200, 384, 576, 768, 1024, 1216])
def test_tc_plan_with_three_pieces_fits_and_fills_the_card(B, D):
    """K2tc3's plan: the query tile of K2tc's, its three pieces' boxes in
    shared memory within 232,448 bytes, the same for every k, at least 3
    stages when streamed, and one wave of one block per SM."""
    N = 1_000_000
    plans = [ttopk.tc_plan(B, N, D, k, pieces=3) for k in (1, 30, 300, 1024)]
    p = plans[0]
    assert all(q.smem == p.smem and q.splits == p.splits for q in plans)
    assert p.query_tile == (64 if B <= 64 else 128)
    assert p.smem == ttopk.tc_smem(p.query_tile, p.resident, p.stages, D, pieces=3) \
        <= ttopk.SMEM_PER_BLOCK
    assert p.stages >= 3
    assert p.resident == (ttopk.tc_smem(p.query_tile, True, 3, D, pieces=3) <= ttopk.SMEM_PER_BLOCK)
    blocks = p.grid_x * p.splits
    if p.grid_x <= ttopk.TC_SMS:
        assert blocks <= ttopk.TC_SMS < blocks + p.grid_x + p.splits
    assert p.splits * p.rows_per_split >= N > (p.splits - 1) * p.rows_per_split


def test_tc_plan_three_pieces_streams_at_d768():
    """At D = 768 a 128-row tile's three pieces take 48 KB a stage beside
    the 16 KB corpus box: 3 stages; a 64-row tile's 24 KB: 5 stages. The
    bytes a call's blocks read are counted from the plan: K2tc's 24.6 GB
    at B = 1024 over 1M x 768, twice that with three pieces."""
    p3 = ttopk.tc_plan(1024, 1_000_000, 768, 30, pieces=3)
    assert (p3.query_tile, p3.resident, p3.stages) == (128, False, 3)
    assert p3.smem == ttopk.tc_smem(128, False, 3, 768) + 3 * 2 * 16384
    p64 = ttopk.tc_plan(64, 1_000_000, 768, 30, pieces=3)
    assert (p64.query_tile, p64.resident, p64.stages) == (64, False, 5)
    p1 = ttopk.tc_plan(1024, 1_000_000, 768, 30)
    assert ttopk.tc_l2_bytes(p1, 1_000_000, 768) == 24_577_572_864
    assert ttopk.tc_l2_bytes(p3, 1_000_000, 768, pieces=3) == 49_155_145_728


def test_query_pieces_layout():
    """The kernels read q as [pieces, B, D] bf16: a bf16 q as it is, an f32
    q as hi, mid, lo."""
    q = torch.randn(5, 64)
    qp = ttopk._query_pieces(q)
    assert qp.shape == (3, 5, 64) and qp.dtype == BF16 and qp.is_contiguous()
    assert torch.equal(qp[0].float() + qp[1].float() + qp[2].float(), q)
    qb = q.to(BF16)
    assert torch.equal(ttopk._query_pieces(qb)[0], qb)

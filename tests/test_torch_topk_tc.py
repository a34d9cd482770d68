"""K1, K2 and K3 over bf16 rows, and K4 over a bf16 xt, on the tensor
cores ("K1tc", `codegraph_tpu_torch/csrc/flat_topk_k1tc.cu`; "K2tc" over
bf16 queries and "K2tc3" over f32 queries, and K4's "K4tc" and "K4tc3",
`csrc/flat_topk_tc.cu`, with "K4tcr" and "K4tc3r" over an xt TMA cannot
read): the route, the host plan of K2tc (K4tc's too), the ragged-row
producer's MN-major stage (`swizzled_xt_stage`), and the wrappers held to
the JAX package's Pallas kernels.

The route and the plan are host code and are tested here as they are. The
wrappers get CPU tensors here, so they run their plain version; inputs are
made with numpy from a seed and handed to both packages, and the Pallas
kernels K2/K3/K4 run in interpret mode, as the JAX package's tests run them.
The CUDA kernels themselves are held to the plain version on the card
(`chip_smoke.py` phase 1, and `tests/test_torch_card.py` where a GPU is
present).

Tolerance: bf16 queries and rows multiply exactly in f32, so the scores of
the two packages differ only by the order of the f32 sums: 1e-5 absolute on
unit-norm rows (scores in [-1, 1]). Ids are equal except where the scores
tie within that tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.ops import topk as jtopk
from codegraph_tpu_torch.ops import topk as ttopk
from tests.test_torch_topk import _case, _t, assert_topk_equiv

K1, K2, K3, K4 = ttopk.K1_LAYOUT, ttopk.K2_LAYOUT, ttopk.K3_LAYOUT, ttopk.K4_LAYOUT
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("q_dtype,x_dtype,layout,want", [
    (BF16, BF16, K2, True), (BF16, BF16, K3, True), (BF16, BF16, K4, True),
    (F32, BF16, K2, True), (F32, BF16, K3, True), (F32, BF16, K4, True),
    (BF16, F32, K2, False), (BF16, F32, K3, False), (BF16, F32, K4, False),
    (F32, F32, K2, False), (F32, F32, K3, False), (F32, F32, K4, False),
    (BF16, BF16, K1, True), (F32, BF16, K1, True), (BF16, F32, K1, False), (F32, F32, K1, False),
])
def test_route_is_set_by_the_inputs(q_dtype, x_dtype, layout, want):
    """bf16 rows in any layout (K4: a bf16 xt) take the tensor cores, under
    bf16 queries and under f32 queries (the sharded scan's, as three bf16
    pieces); f32 rows stay on topk_pass1 and rows_pass1. The route does
    not depend on the layout: K4's own condition on xt's shape is
    `xt_tma_readable`'s."""
    assert ttopk.uses_tensor_cores(q_dtype, x_dtype) is want


@pytest.mark.parametrize("N,addr,want", [
    (8, 0, True), (296, 4096, True), (100008, 16, True), (1_000_000, 1 << 40, True),
    (300, 0, False), (100003, 0, False), (7, 0, False), (1001, 16, False),
    (296, 2, False), (296, 8, False), (1_000_000, (1 << 40) + 4, False),
])
def test_xt_route_is_set_by_n_and_alignment(N, addr, want):
    """K4 over a bf16 xt [D, N] takes TMA's instance (K4tc, K4tc3) where TMA
    can read xt: rows of N bf16 a multiple of 16 bytes (N % 8 == 0) and a
    16-byte aligned base; any other bf16 xt runs the ragged-row producer's
    (K4tcr, K4tc3r), on the tensor cores as well."""
    assert ttopk.xt_tma_readable(N, addr) is want


COUNTED = ("streaming_topk_cuda", "streaming_topk_cuda_qmajor", "streaming_topk_cuda_qres",
           "streaming_topk_cuda_qmajor_xt", "streaming_topk_cuda_tc", "streaming_topk_cuda_tc3",
           "streaming_topk_cuda_k1tc", "streaming_topk_cuda_tc_xt", "streaming_topk_cuda_tc3_xt",
           "streaming_topk_cuda_tc_xt_ragged", "streaming_topk_cuda_tc3_xt_ragged",
           "streaming_topk_cuda_qmajor_xt_ragged")


@pytest.fixture
def card_routes(monkeypatch):
    """The wrappers as they run on a card, with each launch recorded
    instead of made: (route, layout, query dtype) of every launch, the
    tensor-core routes with their query pieces and, for the ragged-row
    producer's instances, " ragged" (K4 for xt, else None)."""
    seen = []

    def rows(q, x, bias, k, layout, piece=16):
        seen.append(("rows_pass1" + ("" if piece == 16 else f" {piece}-byte"), layout, q.dtype))
        return ttopk.streaming_topk(q, x.T if layout == K4 else x, bias, k)

    def col(q, x, bias, k, tm):
        seen.append(("topk_pass1", K1, q.dtype))
        return ttopk.streaming_topk(q, x, bias, k)

    def tc(q, x, bias, k, xt=False, ragged=False):
        route = f"tensor cores x{ttopk.QUERY_PIECES[q.dtype]}" + (" ragged" if ragged else "")
        seen.append((route, K4 if xt else None, q.dtype))
        return ttopk.streaming_topk(q, x.T if xt else x, bias, k)

    def k1tc(q, x, bias, k):
        seen.append((f"K1 tensor cores x{ttopk.QUERY_PIECES[q.dtype]}", K1, q.dtype))
        return ttopk.streaming_topk(q, x, bias, k)

    monkeypatch.setattr(ttopk, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(ttopk, "_launch_rows", rows)
    monkeypatch.setattr(ttopk, "_launch_col", col)
    monkeypatch.setattr(ttopk, "_launch_tc", tc)
    monkeypatch.setattr(ttopk, "_launch_k1tc", k1tc)
    for name in COUNTED:
        monkeypatch.setattr(getattr(ttopk, name), "launches", 0)
    return seen


def _launches():
    return {name: getattr(ttopk, name).launches for name in COUNTED if getattr(ttopk, name).launches}


@pytest.mark.parametrize("q_dtype,x_dtype", [(BF16, BF16), (F32, BF16), (BF16, F32), (F32, F32)])
def test_wrappers_launch_their_route_and_count_it(rng, card_routes, q_dtype, x_dtype):
    """Over bf16 rows K2 and K3 send bf16 queries to K2tc and f32 queries
    to K2tc3 (three pieces), and K4 over a bf16 xt with N % 8 == 0 to K4tc
    and K4tc3 and over a bf16 xt of N = 300 to K4tcr and K4tc3r, each
    counting the launch in its own counter (K2's, K3's and K4's stay as
    they were); f32 rows and an f32 xt launch rows_pass1 and count in K2's,
    K3's or K4's."""
    q, x, bias = _case(rng, 40, 300, 64)
    tq, tx, tb = _t(q, x, bias)
    tq, tx = tq.to(q_dtype), tx.to(x_dtype)
    tc = x_dtype == BF16
    pieces = ttopk.QUERY_PIECES[q_dtype]
    ttopk.streaming_topk_cuda_qmajor(tq, tx, tb, 10)
    ttopk.streaming_topk_cuda_qres(tq, tx, tb, 10)
    ttopk.streaming_topk_cuda_qmajor_xt(tq, tx[:296].T.contiguous(), tb[:296], 10)
    ttopk.streaming_topk_cuda_qmajor_xt(tq, tx.T.contiguous(), tb, 10)  # N % 8 == 4
    want = ([(f"tensor cores x{pieces}", None, q_dtype)] * 2 +
            [(f"tensor cores x{pieces}", K4, q_dtype),
             (f"tensor cores x{pieces} ragged", K4, q_dtype)] if tc else
            [("rows_pass1", K2, q_dtype), ("rows_pass1", K3, q_dtype), ("rows_pass1", K4, q_dtype),
             ("rows_pass1", K4, q_dtype)])
    assert card_routes == want
    tc_name = "streaming_topk_cuda_tc" if pieces == 1 else "streaming_topk_cuda_tc3"
    xt_name = "streaming_topk_cuda_tc_xt" if pieces == 1 else "streaming_topk_cuda_tc3_xt"
    assert _launches() == ({tc_name: 2, xt_name: 1, xt_name + "_ragged": 1} if tc else
                           {"streaming_topk_cuda_qmajor": 1, "streaming_topk_cuda_qres": 1,
                            "streaming_topk_cuda_qmajor_xt": 2})


@pytest.mark.parametrize("q_dtype", [BF16, F32])
@pytest.mark.parametrize("N,offset,tc", [(296, 0, True), (304, 0, True), (297, 0, False),
                                         (300, 0, False), (296, 1, False), (296, 4, False)])
def test_k4_bf16_xt_route_follows_n_and_alignment(rng, card_routes, q_dtype, N, offset, tc):
    """K4 over a bf16 xt sends it to K4tc/K4tc3 where TMA can read it (N %
    8 == 0, a 16-byte aligned base), else to K4tcr/K4tc3r, the ragged-row
    producer's instances (a ragged N, or an xt that starts 2 or 8 bytes
    past 16 inside a larger buffer), and counts the launch in that route's
    counter alone: every bf16 xt runs on the tensor cores."""
    q, x, bias = _case(rng, 40, N, 64)
    tq, tx, tb = _t(q, x, bias)
    buf = torch.zeros(64 * N + 16, dtype=BF16)
    base = (-buf.data_ptr() // 2) % 8 + offset  # elements to a 16-byte boundary, then offset
    txt = buf[base: base + 64 * N].view(64, N)
    txt.copy_(tx.to(BF16).T)
    assert (txt.data_ptr() % 16 == 0) == (offset == 0)
    ttopk.streaming_topk_cuda_qmajor_xt(tq.to(q_dtype), txt, tb, 10)
    pieces = ttopk.QUERY_PIECES[q_dtype]
    xt_name = "streaming_topk_cuda_tc_xt" if pieces == 1 else "streaming_topk_cuda_tc3_xt"
    if tc:
        assert card_routes == [(f"tensor cores x{pieces}", K4, q_dtype)]
        assert _launches() == {xt_name: 1}
    else:
        assert card_routes == [(f"tensor cores x{pieces} ragged", K4, q_dtype)]
        assert _launches() == {xt_name + "_ragged": 1}


@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("N", [296, 297, 300, 302])
def test_k4_f32_xt_route_follows_n_and_alignment(rng, card_routes, N, offset):
    """K4 over an f32 xt runs rows_pass1 in 16-byte pieces, counted in K4's
    launches, only where N % 4 == 0 at a 16-byte aligned base; any other
    f32 xt (N odd or N % 4 = 2, or a base 4 or 8 bytes past 16 inside a
    larger buffer) in 4-byte pieces, K4r, counted in its own launches."""
    q, x, bias = _case(rng, 40, N, 64)
    tq, tx, tb = _t(q, x, bias)
    buf = torch.zeros(64 * N + 16)
    base = (-buf.data_ptr() // 4) % 4 + offset  # elements to a 16-byte boundary, then offset
    txt = buf[base: base + 64 * N].view(64, N)
    txt.copy_(tx.T)
    assert (txt.data_ptr() % 16 == 0) == (offset == 0)
    s, i = ttopk.streaming_topk_cuda_qmajor_xt(tq, txt, tb, 10)
    four = N % 4 != 0 or offset != 0
    assert ttopk.flat_route(txt) == ("4-byte pieces" if four else "16-byte pieces")
    assert card_routes == [("rows_pass1 4-byte" if four else "rows_pass1", K4, F32)]
    assert _launches() == {"streaming_topk_cuda_qmajor_xt" + ("_ragged" if four else ""): 1}
    es, ei = ttopk.streaming_topk(tq, tx, tb, 10)
    assert torch.equal(s, es) and torch.equal(i, ei)


@pytest.mark.parametrize("q_dtype,x_dtype", [(BF16, BF16), (F32, BF16), (BF16, F32), (F32, F32)])
def test_k1_launches_its_route_and_counts_it(rng, card_routes, q_dtype, x_dtype):
    """K1 sends bf16 rows to K1tc under both query dtypes (one piece or
    three), counted in K1tc's launches; f32 rows launch topk_pass1 and
    count in K1's."""
    q, x, bias = _case(rng, 8, 300, 64)
    tq, tx, tb = _t(q, x, bias)
    tq, tx = tq.to(q_dtype), tx.to(x_dtype)
    ttopk.streaming_topk_cuda(tq, tx, tb, 10)
    if x_dtype == BF16:
        assert card_routes == [(f"K1 tensor cores x{ttopk.QUERY_PIECES[q_dtype]}", K1, q_dtype)]
        assert _launches() == {"streaming_topk_cuda_k1tc": 1}
    else:
        assert card_routes == [("topk_pass1", K1, q_dtype)]
        assert _launches() == {"streaming_topk_cuda": 1}


@pytest.mark.parametrize("q_dtype,x_dtype", [(F32, BF16), (BF16, F32), (F32, F32)])
def test_tc_wrapper_refuses_other_inputs(rng, card_routes, q_dtype, x_dtype):
    """On a card the tensor-core wrapper launches bf16 over bf16 or raises:
    it falls back to nothing."""
    q, x, bias = _case(rng, 40, 300, 64)
    tq, tx, tb = _t(q, x, bias)
    with pytest.raises(ValueError, match="bf16 queries over bf16 rows"):
        ttopk.streaming_topk_cuda_tc(tq.to(q_dtype), tx.to(x_dtype), tb, 10)
    assert card_routes == [] and ttopk.streaming_topk_cuda_tc.launches == 0


@pytest.mark.parametrize("name,q_dtype,x_dtype,match", [
    ("streaming_topk_cuda_tc3", BF16, BF16, "f32 queries over bf16 rows"),
    ("streaming_topk_cuda_tc3", F32, F32, "f32 queries over bf16 rows"),
    ("streaming_topk_cuda_k1tc", BF16, F32, "bf16 or f32 queries over bf16 rows"),
    ("streaming_topk_cuda_k1tc", F32, F32, "bf16 or f32 queries over bf16 rows"),
])
def test_new_tc_wrappers_refuse_other_inputs(rng, card_routes, name, q_dtype, x_dtype, match):
    """K2tc3 launches f32 over bf16, K1tc bf16 or f32 over bf16, or they
    raise: neither falls back."""
    q, x, bias = _case(rng, 8, 300, 64)
    tq, tx, tb = _t(q, x, bias)
    with pytest.raises(ValueError, match=match):
        getattr(ttopk, name)(tq.to(q_dtype), tx.to(x_dtype), tb, 10)
    assert card_routes == [] and _launches() == {}


@pytest.mark.parametrize("name,q_dtype,x_dtype,N,match", [
    ("streaming_topk_cuda_tc_xt", F32, BF16, 296, "bf16 queries over a bf16 xt"),
    ("streaming_topk_cuda_tc_xt", BF16, F32, 296, "bf16 queries over a bf16 xt"),
    ("streaming_topk_cuda_tc3_xt", BF16, BF16, 296, "f32 queries over a bf16 xt"),
    ("streaming_topk_cuda_tc3_xt", F32, F32, 296, "f32 queries over a bf16 xt"),
    ("streaming_topk_cuda_tc_xt", BF16, BF16, 300, "N % 8 == 0"),
    ("streaming_topk_cuda_tc3_xt", F32, BF16, 301, "N % 8 == 0"),
    ("streaming_topk_cuda_tc_xt_ragged", F32, BF16, 297, "bf16 queries over a bf16 xt"),
    ("streaming_topk_cuda_tc_xt_ragged", BF16, F32, 297, "bf16 queries over a bf16 xt"),
    ("streaming_topk_cuda_tc3_xt_ragged", BF16, BF16, 300, "f32 queries over a bf16 xt"),
    ("streaming_topk_cuda_tc3_xt_ragged", F32, F32, 300, "f32 queries over a bf16 xt"),
])
def test_xt_tc_wrappers_refuse_other_inputs(rng, card_routes, name, q_dtype, x_dtype, N, match):
    """K4tc launches bf16 over a bf16 xt, K4tc3 f32 over a bf16 xt, each
    only where TMA can read xt, and K4tcr and K4tc3r the same over any bf16
    xt, or they raise: none falls back."""
    q, x, bias = _case(rng, 8, N, 64)
    tq, tx, tb = _t(q, x, bias)
    with pytest.raises(ValueError, match=match):
        getattr(ttopk, name)(tq.to(q_dtype), tx.to(x_dtype).T.contiguous(), tb, 10)
    assert card_routes == [] and _launches() == {}


class _FakeTcLib:
    """csrc/flat_topk_tc.cu's C interface as a recorder: the plan's sizes
    as ops/topk.py computes them, and each launch's arguments."""

    def __init__(self):
        self.launches = []

    def flat_topk_tc_smem(self, qt, resident, stages, D, pieces):
        return ttopk.tc_smem(qt, bool(resident), stages, D, pieces=pieces)

    def flat_topk_tc_work_entries(self, B, k, splits, group):
        return ttopk.work_entries(B, k, splits, group)

    def flat_topk_tc_cand_entries(self, B, qt, splits):
        return -(-B // qt) * splits * ttopk.TC_SLOTS * ttopk.TC_BUF_CAP

    def flat_topk_tc(self, *args):
        self.launches.append(args)
        return 0


@pytest.mark.parametrize("q_dtype", [BF16, F32])
@pytest.mark.parametrize("B,D,N,k", [(70, 768, 4096, 30), (64, 36, 1000, 10),
                                     (129, 200, 296, 300), (1024, 1536, 8, 1)])
def test_k4tc_launch_is_k2tc_plan_over_xt(monkeypatch, rng, q_dtype, B, D, N, k):
    """The K4tc/K4tc3 launch hands flat_topk_tc K2tc's plan for q's depth
    rounded up to 8 (zero columns: TMA's 16-byte rows), xt's own depth
    (its rows past it read as zeros) and N from xt's columns."""
    lib = _FakeTcLib()
    monkeypatch.setattr(ttopk, "_tc_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": ttopk.TC_SMS}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    q, x, bias = _case(rng, B, N, D)
    tq, tx, tb = _t(q, x, bias)
    ttopk._launch_tc_xt(tq.to(q_dtype), tx.to(BF16).T.contiguous(), tb, k)
    (args,) = lib.launches
    pieces = ttopk.QUERY_PIECES[q_dtype]
    d8 = -(-D // 8) * 8
    plan = ttopk.tc_plan(B, N, d8, k, pieces=pieces)
    assert args[1:2] == (pieces,) and args[3] == D and args[5:9] == (B, N, d8, k)
    assert args[9:16] == (plan.query_tile, int(plan.resident), plan.stages, plan.splits,
                          plan.rows_per_split, plan.smem, ttopk.MERGE_GROUP)
    assert plan.smem <= ttopk.SMEM_PER_BLOCK


#: the ragged-row producer's copy over xt [D, N] at a base this many bytes
#: past 16: 2N bytes a row, `load_piece(2N, base)`
XT_PIECES = {(7, 0): 1, (7, 2): 1, (7, 4): 1, (7, 8): 1,
             (297, 0): 1, (297, 2): 1, (297, 4): 1, (297, 8): 1,
             (300, 0): 8, (300, 2): 1, (300, 4): 4, (300, 8): 8,
             (302, 0): 4, (302, 2): 1, (302, 4): 4, (302, 8): 4,
             (1001, 0): 1, (1001, 2): 1, (1001, 4): 1, (1001, 8): 1}


def _xt_at(x_bf16: torch.Tensor, base: int) -> torch.Tensor:
    """x's rows as a bf16 xt [D, N] whose first byte lies `base` bytes past a
    64-byte boundary of its storage."""
    N, D = x_bf16.shape
    buf = torch.zeros(D * N + base // 2 + 32, dtype=BF16)
    skip = (-buf.data_ptr() % 64) // 2 + base // 2
    xt = buf[skip: skip + D * N].view(D, N)
    xt.copy_(x_bf16.T)
    assert xt.data_ptr() % 16 == base
    return xt


@pytest.mark.parametrize("base", [0, 2, 4, 8])
@pytest.mark.parametrize("N", [7, 297, 300, 1001])
def test_swizzled_xt_stage_reads_back_the_rows(rng, N, base):
    """The stage the ragged-row producer writes over a bf16 xt [D, N]
    (`swizzled_xt_stage`: two 64-row boxes of xt's depths, 128 bytes of
    columns each, 128-byte swizzled), read MN-major as K4tc's wgmma reads
    its TMA boxes (box h: depth r at row r, column n0 + 64 h + j at bytes 2
    j after undoing the swizzle), gives back x[n0:n0 + 128, c * 64:(c + 1)
    * 64], with zeros past N and past D, for every chunk c and for the
    first and last tile; the copy width the producer takes at each base is
    `load_piece(2N, base)`, 8- and 4-byte pieces or realigned words."""
    D = 100  # chunk 1 holds depths 64..99, then zeros
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(BF16)
    xt = _xt_at(x, base)
    assert ttopk.load_piece(2 * N, xt.data_ptr()) == XT_PIECES[(N, base)]
    assert not ttopk.xt_tma_readable(N, xt.data_ptr())
    xt_bytes = xt.contiguous().view(torch.uint8).numpy()  # [D, 2N], the bytes the producer reads
    rows16 = x.view(torch.int16).numpy()
    for n0 in sorted({0, (N - 1) // 128 * 128}):
        for c in range(-(-D // 64)):
            stage = ttopk.swizzled_xt_stage(xt_bytes, n0, c).reshape(2, 64, 8, 16)
            plain = np.stack([np.stack([stage[h, r, np.arange(8) ^ (r & 7)] for r in range(64)])
                              for h in range(2)]).reshape(2, 64, 128)
            # [depth, 128 columns] of bf16, then MN-major: [column, depth]
            got = np.concatenate([plain[0], plain[1]], axis=1).view(np.int16).T
            want = np.zeros((128, 64), np.int16)
            cols, deps = min(128, N - n0), min(64, D - 64 * c)
            want[:cols, :deps] = rows16[n0: n0 + cols, 64 * c: 64 * c + deps]
            np.testing.assert_array_equal(got, want)
            assert (got[cols:] == 0).all() and (got[:, deps:] == 0).all()


@pytest.mark.parametrize("q_dtype", [BF16, F32])
@pytest.mark.parametrize("N,base", [(297, 0), (300, 0), (302, 0), (1001, 0), (300, 2), (300, 4),
                                    (300, 8), (296, 8)])
def test_k4tcr_launch_hands_the_producer_its_piece(monkeypatch, rng, q_dtype, N, base):
    """K4tcr/K4tc3r launch flat_topk_tc with K4tc's plan (q's depth rounded
    up to 8, xt's own depth, N from xt's columns) and the producer's copy
    width over xt's rows of 2N bytes, `load_piece(2N, base)`, and the bias
    as it is (4-byte copies); TMA's instance takes piece 0."""
    lib = _FakeTcLib()
    monkeypatch.setattr(ttopk, "_tc_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": ttopk.TC_SMS}))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    B, D, k = 70, 36, 30
    q, x, bias = _case(rng, B, N, D)
    tq, tx, tb = _t(q, x, bias)
    xt = _xt_at(tx.to(BF16), base)
    ttopk._launch_tc_xt(tq.to(q_dtype), xt, tb, k, ragged=True)
    (args,) = lib.launches
    plan = ttopk.tc_plan(B, N, 40, k, pieces=ttopk.QUERY_PIECES[q_dtype])
    assert args[2] == xt.data_ptr() and args[3] == D and args[4] == tb.data_ptr()
    assert args[5:9] == (B, N, 40, k) and args[9:14] == (plan.query_tile, int(plan.resident),
                                                          plan.stages, plan.splits,
                                                          plan.rows_per_split)
    assert args[16] == ttopk.load_piece(2 * N, base) >= 1
    ttopk._launch_tc_xt(tq.to(q_dtype), xt, tb, k)
    assert lib.launches[1][16] == 0


def test_tc_smem_is_the_layout_sum():
    """tc_smem spells out csrc/flat_topk_tc.cu's TcLayout: a 128-row tile
    streamed through 6 stages of 32 KB at D = 768, and a 64-row tile
    resident (12 boxes of 8 KB) beside 6 stages of 16 KB."""
    rest = 1024 + 4 * 128 * 4 + 16 * 160 * 8 + 128 * 5 * 4
    assert ttopk.tc_smem(128, False, 6, 768) == 6 * 32768 + rest + (12 + 1 + 8) * 8 == 222_888
    assert ttopk.tc_smem(64, True, 6, 768) == 6 * 16384 + 12 * 8192 + rest + 21 * 8
    assert ttopk.tc_smem(64, True, 3, 1216) == 3 * 16384 + 19 * 8192 + rest + 15 * 8
    assert ttopk.tc_smem(64, False, 4, 4096) == 4 * 24576 + rest + 17 * 8


def test_tc_smem_over_xt_is_the_layout_sum():
    """K4tc's stage holds a 128-column corpus tile at 64 depths of xt as two
    boxes of 64 columns (the 128-byte swizzle span) x 64 depths: 16 KB, a
    row box's bytes, so K2tc's layout and plan serve it unchanged (K4tc3
    too: three query pieces)."""
    xt_box = (ttopk.TC_BOX_BYTES // 2) * ttopk.TC_BOX_BYTES  # 64 depths of 128-byte rows
    assert 2 * xt_box == ttopk.TC_TILE_N * ttopk.TC_BOX_BYTES == 16384
    rest = 1024 + 4 * 128 * 4 + 16 * 160 * 8 + 128 * 5 * 4
    plan = ttopk.tc_plan(1024, 1_000_000, 768, 30)
    assert (plan.query_tile, plan.resident, plan.stages) == (128, False, 6)
    assert plan.smem == 6 * (2 * xt_box + 128 * 128) + rest + 21 * 8 == 222_888
    plan3 = ttopk.tc_plan(1024, 1_000_000, 768, 30, pieces=3)
    assert plan3.smem == plan3.stages * (2 * xt_box + 3 * 128 * 128) + rest \
        + (2 * plan3.stages + 9) * 8 <= ttopk.SMEM_PER_BLOCK
    plan64 = ttopk.tc_plan(64, 1_000_000, 40, 10)  # D = 36 padded to 40: one 64-depth chunk
    assert plan64.resident and plan64.smem == 1024 + plan64.stages * 2 * xt_box + 64 * 128 + \
        4 * 128 * 4 + 16 * 160 * 8 + 128 * 5 * 4 + (2 * plan64.stages + 9) * 8


@pytest.mark.parametrize("B", [1, 32, 33, 64, 65, 128, 129, 256, 1000, 1024, 4096, 20000])
@pytest.mark.parametrize("D", [8, 64, 200, 576, 640, 768, 1024, 1216, 1224, 1536, 4096])
def test_tc_plan_fits_and_fills_the_card(B, D):
    """For every batch, depth and k: a 64- or 128-row query tile, shared
    memory within a block's 232,448 bytes and the same for every k, at
    least 2 ring stages, the query tile resident exactly where it fits
    beside 3 stages (64 rows to D = 1,216, 128 rows to D = 576), whole
    corpus tiles a split covering the corpus, and the blocks one wave of
    one block per SM that fills the 132 SMs."""
    N = 1_000_000
    plans = [ttopk.tc_plan(B, N, D, k) for k in (1, 30, 300, 1024)]
    p = plans[0]
    assert all(q.smem == p.smem and q.splits == p.splits for q in plans)
    assert p.query_tile == (64 if B <= 64 else 128)
    assert p.smem == ttopk.tc_smem(p.query_tile, p.resident, p.stages, D) <= ttopk.SMEM_PER_BLOCK
    assert p.stages >= 2
    assert p.resident == (D <= (1216 if p.query_tile == 64 else 576))
    assert p.rows_per_split % ttopk.TC_TILE_N == 0
    assert p.splits * p.rows_per_split >= N > (p.splits - 1) * p.rows_per_split
    assert p.grid_x == -(-B // p.query_tile)
    blocks = p.grid_x * p.splits
    if p.grid_x <= ttopk.TC_SMS:
        assert blocks <= ttopk.TC_SMS  # one wave
        assert blocks > ttopk.TC_SMS - p.grid_x - p.splits  # that fills the card
    else:
        assert p.splits == 1
    assert p.bound_entries == B * p.splits
    assert p.cand_entries == blocks * ttopk.TC_SLOTS * ttopk.TC_BUF_CAP
    assert all(q.work_entries == ttopk.work_entries(B, q_k, p.splits)
               for q, q_k in zip(plans, (1, 30, 300, 1024)))


@pytest.mark.parametrize("N", [1, 127, 128, 200, 100003])
def test_tc_plan_small_and_ragged_corpora(N):
    """A corpus of fewer rows than the card has SMs takes one split a tile;
    the last split is never empty."""
    p = ttopk.tc_plan(1000, N, 768, 30)
    assert p.splits * p.rows_per_split >= N > (p.splits - 1) * p.rows_per_split
    assert p.splits <= -(-N // ttopk.TC_TILE_N)


def _pallas(kernel, q, x, bias, k, tile_b):
    jfn = {"K2": jtopk.streaming_topk_pallas_qmajor, "K3": jtopk.streaming_topk_pallas_qres}[kernel]
    B, D = q.shape
    qpad = np.zeros((-(-B // tile_b) * tile_b, D), np.float32)
    qpad[:B] = q  # the Pallas kernels take whole query tiles
    js, ji = jfn(jnp.asarray(qpad, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16), jnp.asarray(bias),
                 k, tile_n=256, tile_b=tile_b, interpret=True)
    return np.asarray(js)[:B], np.asarray(ji)[:B]


@pytest.mark.parametrize("kernel,B,k", [
    ("K2", 64, 10), ("K2", 65, 300), ("K2", 128, 30), ("K2", 129, 1), ("K2", 1000, 300),
    ("K3", 64, 300), ("K3", 129, 30), ("K3", 1000, 10),
])
def test_bf16_wrappers_match_jax_pallas(rng, kernel, B, k):
    """bf16 K2 and K3 (the tensor-core route's wrappers, plain on CPU
    tensors) against the Pallas kernels in interpret mode on the same bf16
    inputs, at the edges of the 64- and 128-row query tiles, with
    duplicate rows (exact ties), tombstones, and k above the live count
    (200 of 512 rows live, 1% of those tombstoned)."""
    N, D = 512, 64
    q, x, bias = _case(rng, B, N, D, dead_frac=0.01)
    x[100:150] = x[0:50]  # exact ties: rows 100..149 repeat rows 0..49
    q[0] = x[5]           # its own duplicate pair tops query 0's list
    bias[200:] = ttopk.NEG_INF
    js, ji = _pallas(kernel, q, x, bias, k, 64)
    tq, tx, tb = _t(q, x, bias)
    tq, tx = tq.to(BF16), tx.to(BF16)
    fn = {"K2": ttopk.streaming_topk_cuda_qmajor, "K3": ttopk.streaming_topk_cuda_qres}[kernel]
    ts, ti = fn(tq, tx, tb, k)
    assert ttopk.streaming_topk_cuda_tc(tq, tx, tb, k)[1].equal(ti)
    assert_topk_equiv(ts, ti, js, ji, tq.float().numpy(), tx.float().numpy(), bias)
    if k > 1:  # query 0 holds both rows of its duplicate pair, the lower id first
        assert list(ti[0, :2].numpy()) == [5, 105]
        assert sorted(np.asarray(ji)[0, :2].tolist()) == [5, 105]
    live = int((bias > ttopk.NEG_INF / 2).sum())
    if k > live:
        assert (ti[:, live:] == -1).all() and (ts[:, live:] == ttopk.NEG_INF).all()


def _pallas_xt(q, xt, bias, k, tile_b, q_jdtype):
    B, D = q.shape
    qpad = np.zeros((-(-B // tile_b) * tile_b, D), np.float32)
    qpad[:B] = q  # the Pallas kernel takes whole query tiles
    js, ji = jtopk.streaming_topk_pallas_qmajor_xt(
        jnp.asarray(qpad, q_jdtype), jnp.asarray(xt, jnp.bfloat16), jnp.asarray(bias), k,
        tile_n=256, tile_b=tile_b, interpret=True)
    return np.asarray(js)[:B], np.asarray(ji)[:B]


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("B,N,k", [(64, 512, 10), (65, 512, 300), (129, 1024, 30),
                                   (64, 768, 100)])
def test_k4_bf16_xt_wrappers_match_jax_pallas(rng, q_dtype, B, N, k):
    """K4 over a bf16 xt (K4tc with bf16 queries, K4tc3 with f32 queries:
    the wrappers' plain version on CPU tensors) against
    `streaming_topk_pallas_qmajor_xt` in interpret mode on the same bf16
    xt and queries, which takes f32 queries over a bf16 xt as they are.
    Duplicate rows (exact ties), one of them across the two 64-column
    halves of a 128-column tile (rows 6 and 70, query 0 on row 6),
    tombstones, and k above the live count (200 of N rows live)."""
    D = 64
    q, x, bias = _case(rng, B, N, D, dead_frac=0.01)
    x[300:350] = x[100:150]
    x[70] = x[6]
    bias[6] = bias[70] = 0.0
    bias[200:] = ttopk.NEG_INF
    x = torch.from_numpy(x).to(BF16).float().numpy()  # the bf16 rows, exactly
    q[0] = x[6]
    td = getattr(torch, q_dtype)
    q = torch.from_numpy(q).to(td).float().numpy()  # the queries in their own dtype
    xt = np.ascontiguousarray(x.T)
    js, ji = _pallas_xt(q, xt, bias, k, 64, jnp.bfloat16 if q_dtype == "bfloat16" else jnp.float32)
    tq, txt, tb = _t(q, xt, bias)
    tq, txt = tq.to(td), txt.to(BF16)
    ts, ti = ttopk.streaming_topk_cuda_qmajor_xt(tq, txt, tb, k)
    assert_topk_equiv(ts, ti, js, ji, q, x, bias)
    wrapper = ttopk.streaming_topk_cuda_tc_xt if td == BF16 else ttopk.streaming_topk_cuda_tc3_xt
    ws, wi = wrapper(tq, txt, tb, k)
    ks, ki = ttopk.streaming_topk_cuda_qmajor(tq, txt.T.contiguous(), tb, k)
    assert torch.equal(ws, ts) and torch.equal(wi, ti)
    assert torch.equal(ks, ts) and torch.equal(ki, ti)  # K2 on xt.T: the same function
    if k > 1:  # query 0 holds both rows of the pair across the halves, the lower id first
        assert list(ti[0, :2].numpy()) == [6, 70]
        assert sorted(np.asarray(ji)[0, :2].tolist()) == [6, 70]
    if k > 200:
        assert (ti[:, 200:] == -1).all() and (ts[:, 200:] == ttopk.NEG_INF).all()


@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("N", [297, 300, 1001])
@pytest.mark.parametrize("B,k", [(65, 300), (129, 30)])
def test_k4_ragged_bf16_xt_matches_jax_pallas(rng, card_routes, q_dtype, N, B, k):
    """K4 over a bf16 xt whose N TMA cannot read takes K4tcr (bf16 queries)
    or K4tc3r (f32 queries) on a card, and its function is the JAX
    package's: the wrapper (its launch recorded, the plain version run)
    against `streaming_topk_pallas_qmajor_xt` in interpret mode on the same
    bf16 xt padded with zero columns to whole 256-column tiles whose bias is
    NEG_INF (the Pallas kernel takes whole tiles; such columns never enter
    a list). Duplicate rows across the two 64-column halves of a tile,
    tombstones, the last tile running past N, k above the live count at
    N = 297 (150 live). Tolerance 1e-5 on unit rows, ids equal but where
    scores tie (`assert_topk_equiv`)."""
    D = 64
    q, x, bias = _case(rng, B, N, D, dead_frac=0.01)
    x[70] = x[6]
    bias[6] = bias[70] = 0.0
    if N == 297:
        bias[150:] = ttopk.NEG_INF
    x = torch.from_numpy(x).to(BF16).float().numpy()  # the bf16 rows, exactly
    q[0] = x[6]
    td = getattr(torch, q_dtype)
    q = torch.from_numpy(q).to(td).float().numpy()  # the queries in their own dtype
    n_pad = -(-N // 256) * 256
    xt_pad = np.zeros((D, n_pad), np.float32)
    xt_pad[:, :N] = x.T
    bias_pad = np.full(n_pad, ttopk.NEG_INF, np.float32)
    bias_pad[:N] = bias
    js, ji = _pallas_xt(q, xt_pad, bias_pad, k, 64,
                        jnp.bfloat16 if q_dtype == "bfloat16" else jnp.float32)
    tq, txt, tb = _t(q, np.ascontiguousarray(x.T), bias)
    tq, txt = tq.to(td), txt.to(BF16)
    ts, ti = ttopk.streaming_topk_cuda_qmajor_xt(tq, txt, tb, k)
    pieces = ttopk.QUERY_PIECES[td]
    assert card_routes == [(f"tensor cores x{pieces} ragged", K4, td)]
    assert_topk_equiv(ts, ti, js, ji, q, x, bias)
    assert list(ti[0, :2].numpy()) == [6, 70]  # the pair across the halves, lower id first
    live = int((bias > ttopk.NEG_INF / 2).sum())
    if k > live:
        assert (ti[:, live:] == -1).all() and (ts[:, live:] == ttopk.NEG_INF).all()


def test_pallas_xt_takes_f32_queries_over_bf16_xt_exactly(rng):
    """The JAX K4 kernel multiplies f32 queries by a bf16 xt in f32 (the
    function K4tc3 computes with three bf16 pieces a query): at 64 x 64 x
    512 its k best scores are q @ xt_bf16.astype(f32) + bias's, to 0.0."""
    q, x, bias = _case(rng, 64, 512, 64)
    xt = np.ascontiguousarray(torch.from_numpy(x).to(BF16).float().numpy().T)
    js, ji = _pallas_xt(q, xt, bias, 10, 64, jnp.float32)
    full = q @ xt + bias[None, :]
    np.testing.assert_array_equal(js, np.take_along_axis(full, ji.astype(np.int64), 1))


def _variants_tool():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                        "flat_topk_tc_variants.py")
    spec = importlib.util.spec_from_file_location("flat_topk_tc_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(_variants_tool().VARIANTS))
def test_tc_variant_tool_anchors_in_source(name):
    """Every text change of tools/flat_topk_tc_variants.py still applies to
    csrc/flat_topk_tc.cu or csrc/topk_merge.cuh, and every ops/topk.py
    constant it sets exists."""
    from codegraph_tpu_torch.ops import cuda_build

    tool = _variants_tool()
    srcs = [(cuda_build.CSRC_DIR / f).read_text() for f in tool.SOURCES]
    subs, consts, _ = tool.VARIANTS[name]
    for anchor, _ in subs:
        assert any(anchor in src for src in srcs)
    for const in consts:
        assert hasattr(ttopk, const)

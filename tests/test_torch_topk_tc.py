"""K2 and K3 over bf16 queries and bf16 rows on the tensor cores ("K2tc",
`codegraph_tpu_torch/csrc/flat_topk_tc.cu`): the route, the host plan, and
the wrappers held to the JAX package's Pallas kernels.

The route and the plan are host code and are tested here as they are. The
wrappers get CPU tensors here, so they run their plain version; inputs are
made with numpy from a seed and handed to both packages, and the Pallas
kernels K2/K3 run in interpret mode, as the JAX package's tests run them.
The CUDA kernel itself is held to the plain version on the card
(`chip_smoke.py` phase 1, and `test_tc_kernel_matches_plain_on_card` below
where a GPU is present).

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

K2, K3, K4 = ttopk.K2_LAYOUT, ttopk.K3_LAYOUT, ttopk.K4_LAYOUT
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("q_dtype,x_dtype,layout,want", [
    (BF16, BF16, K2, True), (BF16, BF16, K3, True), (BF16, BF16, K4, False),
    (F32, BF16, K2, False), (F32, BF16, K3, False), (F32, BF16, K4, False),
    (BF16, F32, K2, False), (BF16, F32, K3, False), (BF16, F32, K4, False),
    (F32, F32, K2, False), (F32, F32, K3, False), (F32, F32, K4, False),
])
def test_route_is_set_by_the_inputs(q_dtype, x_dtype, layout, want):
    """bf16 queries over bf16 rows in K2's or K3's layout take the tensor
    cores; f32 queries over bf16 rows (the sharded scan's), f32 rows and
    K4 over any xt stay on rows_pass1."""
    assert ttopk.uses_tensor_cores(q_dtype, x_dtype, layout) is want


@pytest.fixture
def card_routes(monkeypatch):
    """The wrappers as they run on a card, with each launch recorded
    instead of made: (route, layout) of every launch."""
    seen = []

    def rows(q, x, bias, k, layout):
        seen.append(("rows_pass1", layout, q.dtype))
        return ttopk.streaming_topk(q, x.T if layout == K4 else x, bias, k)

    def tc(q, x, bias, k):
        seen.append(("tensor cores", None, q.dtype))
        return ttopk.streaming_topk(q, x, bias, k)

    monkeypatch.setattr(ttopk, "_on_cpu", lambda *tensors: False)
    monkeypatch.setattr(ttopk, "_launch_rows", rows)
    monkeypatch.setattr(ttopk, "_launch_tc", tc)
    for fn in (ttopk.streaming_topk_cuda_qmajor, ttopk.streaming_topk_cuda_qres,
               ttopk.streaming_topk_cuda_qmajor_xt, ttopk.streaming_topk_cuda_tc):
        monkeypatch.setattr(fn, "launches", 0)
    return seen


@pytest.mark.parametrize("q_dtype,x_dtype", [(BF16, BF16), (F32, BF16), (BF16, F32), (F32, F32)])
def test_wrappers_launch_their_route_and_count_it(rng, card_routes, q_dtype, x_dtype):
    """K2 and K3 send bf16 over bf16 to the tensor-core wrapper, which
    counts the launch in its own counter (K2's and K3's stay as they were);
    every other input launches rows_pass1 and counts in K2's or K3's; K4
    always launches rows_pass1."""
    q, x, bias = _case(rng, 40, 300, 64)
    tq, tx, tb = _t(q, x, bias)
    tq, tx = tq.to(q_dtype), tx.to(x_dtype)
    tc = q_dtype == x_dtype == BF16
    ttopk.streaming_topk_cuda_qmajor(tq, tx, tb, 10)
    ttopk.streaming_topk_cuda_qres(tq, tx, tb, 10)
    ttopk.streaming_topk_cuda_qmajor_xt(tq, tx.T.contiguous(), tb, 10)
    want = ([("tensor cores", None, q_dtype)] * 2 if tc else
            [("rows_pass1", K2, q_dtype), ("rows_pass1", K3, q_dtype)])
    assert card_routes == want + [("rows_pass1", K4, q_dtype)]
    assert ttopk.streaming_topk_cuda_tc.launches == (2 if tc else 0)
    assert ttopk.streaming_topk_cuda_qmajor.launches == ttopk.streaming_topk_cuda_qres.launches \
        == (0 if tc else 1)
    assert ttopk.streaming_topk_cuda_qmajor_xt.launches == 1


@pytest.mark.parametrize("q_dtype,x_dtype", [(F32, BF16), (BF16, F32), (F32, F32)])
def test_tc_wrapper_refuses_other_inputs(rng, card_routes, q_dtype, x_dtype):
    """On a card the tensor-core wrapper launches bf16 over bf16 or raises:
    it falls back to nothing."""
    q, x, bias = _case(rng, 40, 300, 64)
    tq, tx, tb = _t(q, x, bias)
    with pytest.raises(ValueError, match="bf16 queries over bf16 rows"):
        ttopk.streaming_topk_cuda_tc(tq.to(q_dtype), tx.to(x_dtype), tb, 10)
    assert card_routes == [] and ttopk.streaming_topk_cuda_tc.launches == 0


def test_tc_smem_is_the_layout_sum():
    """tc_smem spells out csrc/flat_topk_tc.cu's TcLayout: a 128-row tile
    streamed through 6 stages of 32 KB at D = 768, and a 64-row tile
    resident (12 boxes of 8 KB) beside 6 stages of 16 KB."""
    rest = 1024 + 4 * 128 * 4 + 16 * 160 * 8 + 128 * 5 * 4
    assert ttopk.tc_smem(128, False, 6, 768) == 6 * 32768 + rest + (12 + 1 + 8) * 8 == 222_888
    assert ttopk.tc_smem(64, True, 6, 768) == 6 * 16384 + 12 * 8192 + rest + 21 * 8
    assert ttopk.tc_smem(64, True, 3, 1216) == 3 * 16384 + 19 * 8192 + rest + 15 * 8
    assert ttopk.tc_smem(64, False, 4, 4096) == 4 * 24576 + rest + 17 * 8


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_tc_kernel_matches_plain_on_card(cuda_device):
    """The tensor-core kernel against its plain version at both query
    tiles, a ragged N, a depth that is not a multiple of 64, and k from 1 to
    1024; f32 queries over the same rows run rows_pass1."""
    rng = np.random.default_rng(15)
    for D in (768, 200):
        q, x, bias = _case(rng, 129, 5003, D, dead_frac=0.01)
        tq, tx, tb = (t.to(cuda_device) for t in _t(q, x, bias))
        tq, tx = tq.to(BF16), tx.to(BF16)
        for B in (33, 64, 65, 129):
            for k in (1, 30, 300, 1024):
                before = ttopk.streaming_topk_cuda_tc.launches
                ks, ki = ttopk.streaming_topk_cuda_qmajor(tq[:B].contiguous(), tx, tb, k)
                assert ttopk.streaming_topk_cuda_tc.launches == before + 1
                ps, pi = ttopk.streaming_topk(tq[:B], tx, tb, k)
                assert_topk_equiv(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(),
                                  tq[:B].float().cpu().numpy(), tx.float().cpu().numpy(), bias)
    before = ttopk.streaming_topk_cuda_tc.launches
    ttopk.streaming_topk_cuda_qmajor(tq.float(), tx, tb, 30)
    assert ttopk.streaming_topk_cuda_tc.launches == before


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

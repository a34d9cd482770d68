"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every case here needs an NVIDIA GPU: it is marked `cuda` and skips inside
the `cuda_device` fixture when `torch.cuda.is_available()` is false, so on
the CPU the file collects and skips. The card's machine has no JAX, so
this file imports only torch, numpy, pytest and the port, and takes none of
the conftest's fixtures: on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_card.py

(`chip_smoke.py` runs that command; `tests/conftest.py` imports JAX).
The CPU tests hold the plain versions to the JAX package; these cases
hold each kernel to its plain version on the same inputs, made with numpy
from a seed.

Tolerances: f32 and bf16 scores within 1e-5 (unit-norm rows and queries,
scores in [-1, 1]: f32 sums taken in another order differ by ~1e-7 at
D = 768, and bf16 products, and the bf16 pieces of an f32 query times a
bf16 row, are exact in f32), ids equal except where the scores tie within
that bound; the pieces of an f32 query against one-hot bf16 rows bit
for bit (each score then has one nonzero term, so no summation order can
blur it); int8 scan scores bit for bit, ids equal except where the true
scores tie within 1e-6; K8's scores within 1e-5 of the
true ADC sums; the bf16 training step's gradients within 2e-2 relative L2
of the CPU route's.
"""

import numpy as np
import pytest
import torch

from codegraph_tpu_torch.index import ivfpq as tivfpq
from codegraph_tpu_torch.index.ivfpq import IVFPQIndex
from codegraph_tpu_torch.models import training as tt
from codegraph_tpu_torch.models.encoder import EncoderConfig, init_encoder_params
from codegraph_tpu_torch.ops import quantize as tq
from codegraph_tpu_torch.ops import topk as ttopk
from codegraph_tpu_torch.ops.bf16_split import split_bf16

TOL = 1e-5
#: the int8 scans' tie judge: an id may differ only where the true scores
#: (`_int8_true`) are within this of each other
INT8_TIE_TOL = 1e-6
BF16, F32 = torch.bfloat16, torch.float32
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _unit(a):
    n = np.linalg.norm(a, axis=1, keepdims=True)
    return (a / np.maximum(n, 1e-6)).astype(np.float32)


def _case(rng, B, N, D, dead_frac=0.0):
    q = _unit(rng.standard_normal((B, D)))
    x = _unit(rng.standard_normal((N, D)))
    bias = np.zeros(N, np.float32)
    if dead_frac:
        bias[rng.choice(N, size=max(1, int(N * dead_frac)), replace=False)] = ttopk.NEG_INF
    return q, x, bias


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


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


def _held(fn, q, x, bias, k, counted):
    """fn(q, x, bias, k) on the card against the plain version, with
    exactly one launch counted in `counted.launches`."""
    before = counted.launches
    ks, ki = fn(q, x, bias, k)
    torch.cuda.synchronize()
    assert counted.launches == before + 1, (counted.__name__, q.dtype, x.dtype, q.shape, k)
    ps, pi = ttopk.streaming_topk(q, x, bias, k)
    assert_topk_equiv(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), q.float().cpu().numpy(),
                      x.float().cpu().numpy(), bias.cpu().numpy())


# -- K1-K4: csrc/flat_topk.cu, flat_topk_tc.cu, flat_topk_k1tc.cu -------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(cuda_device, dtype):
    rng = np.random.default_rng(1)
    q, x, bias = _case(rng, 70, 5000, 768, dead_frac=0.01)
    td = getattr(torch, dtype)
    tq_, tx, tb = (t.to(cuda_device) for t in _t(q, x, bias))
    tq_, tx = tq_.to(td), tx.to(td)
    xt = tx.T.contiguous()
    k4 = lambda q_, x_, b_, k_: ttopk.streaming_topk_cuda_qmajor_xt(q_, xt, b_, k_)
    for fn, B in ((ttopk.streaming_topk_cuda, 3), (ttopk.streaming_topk_cuda_qmajor, 70),
                  (ttopk.streaming_topk_cuda_qres, 70), (k4, 70),
                  (ttopk.streaming_topk_cuda_qmajor, 40), (ttopk.streaming_topk_cuda_qres, 64),
                  (k4, 33), (ttopk.streaming_topk_cuda_qmajor, 20),
                  (k4, 32)):  # 128-, 64- and 32-row query tiles
        for k in (1, 30, 300, 1024):
            ks, ki = fn(tq_[:B].contiguous(), tx, tb, k)
            ps, pi = ttopk.streaming_topk(tq_[:B], tx, tb, k)
            assert_topk_equiv(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(),
                              tq_[:B].float().cpu().numpy(), tx.float().cpu().numpy(), bias)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_matches_plain_on_card(cuda_device, dtype):
    rng = np.random.default_rng(2)
    q, x, bias = _case(rng, 70, 5003, 768, dead_frac=0.01)
    td = getattr(torch, dtype)
    tq_, txt, tb = (t.to(cuda_device) for t in _t(q, np.ascontiguousarray(x.T), bias))
    tq_, txt = tq_.to(td), txt.to(td)
    for k in (1, 30, 300):
        ks, ki = ttopk.streaming_topk_cuda_qmajor_xt(tq_, txt, tb, k)
        ps, pi = ttopk.streaming_topk(tq_, txt.T, tb, k)
        assert_topk_equiv(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), tq_.float().cpu().numpy(),
                          txt.float().cpu().numpy().T, bias)


@pytest.mark.cuda
def test_tc_kernel_matches_plain_on_card(cuda_device):
    """The tensor-core kernel against its plain version at both query
    tiles, a ragged N, a depth that is not a multiple of 64, and k from 1 to
    1024; f32 queries over the same rows run its three-piece form (K2tc3)."""
    rng = np.random.default_rng(15)
    for D in (768, 200):
        q, x, bias = _case(rng, 129, 5003, D, dead_frac=0.01)
        tq_, tx, tb = (t.to(cuda_device) for t in _t(q, x, bias))
        tq_, tx = tq_.to(BF16), tx.to(BF16)
        for B in (33, 64, 65, 129):
            for k in (1, 30, 300, 1024):
                _held(ttopk.streaming_topk_cuda_qmajor, tq_[:B].contiguous(), tx, tb, k,
                      ttopk.streaming_topk_cuda_tc)
    before = ttopk.streaming_topk_cuda_tc.launches
    ttopk.streaming_topk_cuda_qmajor(tq_.float(), tx, tb, 30)
    assert ttopk.streaming_topk_cuda_tc.launches == before


def _bf16_case(rng, dev, B, N, D, dup=False, live=None):
    """Unit queries (f32) and bf16 rows on `dev` with 1% tombstones; dup:
    rows 100..149 repeat rows 0..49 (exact ties) and query 0 is row 5;
    live: rows from `live` on are dead (k above the live count)."""
    q, x, bias = _case(rng, B, N, D, dead_frac=0.01)
    if dup:
        x[100:150] = x[0:50]
    if live is not None:
        bias[live:] = ttopk.NEG_INF
    tq_, tx, tb = (t.to(dev) for t in _t(q, x, bias))
    tx = tx.to(BF16)
    if dup:
        tq_[0] = tx[5].float()
    return tq_, tx, tb


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_k2tc_pieces_match_plain_on_card(cuda_device, q_dtype):
    """K2 and K3 over bf16 rows under bf16 queries (K2tc) and f32 queries
    (K2tc3, three pieces) against the plain version: both query tiles,
    ties, tombstones, k above the live rows, a depth not a multiple of
    64, and K3's route."""
    rng = np.random.default_rng(16)
    qd = getattr(torch, q_dtype)
    counted = ttopk.streaming_topk_cuda_tc if qd == BF16 else ttopk.streaming_topk_cuda_tc3
    for D, N, live, dup in ((768, 5003, None, True), (200, 300, 150, False)):
        tq_, tx, tb = _bf16_case(rng, cuda_device, 129, N, D, dup=dup, live=live)
        tq_ = tq_.to(qd)
        for fn, B in ((ttopk.streaming_topk_cuda_qmajor, 33), (ttopk.streaming_topk_cuda_qmajor, 64),
                      (ttopk.streaming_topk_cuda_qmajor, 65), (ttopk.streaming_topk_cuda_qres, 129)):
            for k in (1, 30, 300, 1024):
                _held(fn, tq_[:B].contiguous(), tx, tb, k, counted)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype", ["bfloat16", "float32"])
def test_k1tc_matches_plain_on_card(cuda_device, q_dtype):
    """K1 over bf16 rows (K1tc) under bf16 and f32 queries against the plain
    version: every query tile (B = 1 ... 32, and a second tile at 40),
    ties, tombstones, k above the live rows, a ragged N, depths not a
    multiple of 64, a resident and a streamed query tile."""
    rng = np.random.default_rng(17)
    qd = getattr(torch, q_dtype)
    for D, N, live, dup in ((768, 20011, None, True), (200, 300, 150, False),
                            (1536, 3001, None, False)):
        tq_, tx, tb = _bf16_case(rng, cuda_device, 40, N, D, dup=dup, live=live)
        tq_ = tq_.to(qd)
        for B in (1, 5, 8, 9, 17, 31, 40):
            for k in (1, 30, 300, 1024):
                _held(ttopk.streaming_topk_cuda, tq_[:B].contiguous(), tx, tb, k,
                      ttopk.streaming_topk_cuda_k1tc)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["K1tc", "K2tc3"])
def test_pieces_exact_on_one_hot_rows_on_card(cuda_device, route):
    """The three-piece routes use every piece: over one-hot bf16 rows
    (row n is e_(n % D), so rows n and n + D tie exactly) a score is the one
    query element q[n % D] (+ a zero bias), whatever the order of the sums,
    and equals the plain version's bit for bit. The f32 queries carry 24
    significant bits, so nearly every `lo` piece is nonzero: a kernel that
    dropped or repeated a piece would miss by 1e-7 to 1e-6, inside the 1e-5
    that random rows allow. K1tc at one, two and four 8-row query tiles;
    K2tc3 on both sides of its 64- and 128-row query tiles, and K3's
    route."""
    rng = np.random.default_rng(18)
    fn, counted, runs = {
        "K1tc": (ttopk.streaming_topk_cuda, ttopk.streaming_topk_cuda_k1tc, (1, 8, 9, 31)),
        "K2tc3": (ttopk.streaming_topk_cuda_qmajor, ttopk.streaming_topk_cuda_tc3,
                  (33, 64, 65, 129)),
    }[route]
    for D, N in ((768, 3 * 768 + 5), (200, 1003)):
        q = _unit(rng.standard_normal((max(runs), D)))
        x = np.zeros((N, D), np.float32)
        x[np.arange(N), np.arange(N) % D] = 1.0
        bias = np.zeros(N, np.float32)
        bias[rng.choice(N, size=N // 100, replace=False)] = ttopk.NEG_INF
        tq_, tx, tb = (t.to(cuda_device) for t in _t(q, x, bias))
        tx = tx.to(BF16)
        lo = split_bf16(tq_)[2]
        assert float((lo != 0).float().mean()) > 0.9
        calls = [(fn, B) for B in runs]
        if route == "K2tc3":
            calls.append((ttopk.streaming_topk_cuda_qres, 129))
        for f, B in calls:
            for k in (1, 30, 300, 1024):
                qb = tq_[:B].contiguous()
                before = counted.launches
                ks, ki = f(qb, tx, tb, k)
                torch.cuda.synchronize()
                assert counted.launches == before + 1, (route, B, k)
                ps, pi = ttopk.streaming_topk(qb, tx, tb, k)
                assert_topk_equiv(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), q[:B], x, bias, tol=0.0)


# -- K5-K7: csrc/int8_topk.cu ---------------------------------------------------


def _int8_case(rng, B, N, D, dead_frac=0.01):
    q = _unit(rng.standard_normal((B, D)))
    x = _unit(rng.standard_normal((N, D)))
    x[min(7, N - 1)] = 0.0  # an all-zero row gets scale 0
    qv, qs = (a.numpy() for a in tq.quantize_rows(torch.from_numpy(q)))
    xv, xs = (a.numpy() for a in tq.quantize_rows(torch.from_numpy(x)))
    bias = np.zeros(N, np.float32)
    if dead_frac:
        bias[rng.choice(N, size=max(1, int(N * dead_frac)), replace=False)] = ttopk.NEG_INF
    return qv, qs, xv, xs, bias


def _int8_true(qv, qs, xv, xs, bias):
    """The reference's f32 scores, computed in numpy: the exact integer dot,
    then * qs, * xs and + bias, each rounded to f32."""
    raw = (np.asarray(qv, np.int64) @ np.asarray(xv, np.int64).T).astype(np.float32)
    return (raw * np.asarray(qs)[:, None] * np.asarray(xs)[None, :]
            + np.asarray(bias)[None, :]).astype(np.float32)


@pytest.mark.cuda
def test_int8_kernels_match_plain_on_card(cuda_device):
    """Each kernel equals the plain version bit for bit on its scores, with
    ids equal outside ties: K5, K6 and K7 on both sides of the 64- and
    128-row query tiles, and the mma.sync kernel at a D that TMA cannot
    take."""
    rng = np.random.default_rng(1)
    for D, runs in ((768, ((tq.streaming_topk_int8_cuda, 3), (tq.streaming_topk_int8_cuda_qmajor, 64),
                           (tq.streaming_topk_int8_cuda_qmajor, 70),
                           (tq.streaming_topk_int8_cuda_qmajor, 129),
                           (tq.streaming_topk_int8_cuda_qres, 70),
                           (tq.streaming_topk_int8_cuda_qres, 129))),
                    (100, ((tq.streaming_topk_int8_cuda_qmajor, 70),))):
        case = _int8_case(rng, 129, 5000, D)
        tc = [t.to(cuda_device) for t in _t(*case)]
        for fn, B in runs:
            sub = [tc[0][:B].contiguous(), tc[1][:B].contiguous(), *tc[2:]]
            for k in (1, 100, 300):
                ks, ki = fn(*sub, k)
                ps, pi = tq.streaming_topk_int8(*sub, k)
                np.testing.assert_array_equal(ks.cpu().numpy(), ps.cpu().numpy())
                assert_topk_equiv(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), None, None, None,
                                  tol=INT8_TIE_TOL,
                                  true=_int8_true(case[0][:B], case[1][:B], *case[2:]))


# -- K8: csrc/ivfpq_adc.cu --------------------------------------------------------

IVF_D = 32


@pytest.fixture
def ivfpq_state():
    """A small clustered corpus (with duplicate rows: exact ties inside a
    cell) in the port's own IVFPQIndex, trained, filled and 1 in 29 rows
    deleted, on the CPU."""
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((12, IVF_D))
    x = (centers[rng.integers(0, 12, 1200)] + 0.3 * rng.standard_normal((1200, IVF_D)))
    x = x.astype(np.float32)
    x[600:620] = x[100:120]
    t = IVFPQIndex(IVF_D, nlist=16, nprobe=6, m=8, kmeans_iters=4, pq_iters=4, device="cpu")
    t.train(x)
    t.add(x)
    t.delete(np.arange(0, len(x), 29))
    return x, t


def _adc_judge(t, q):
    """[B, n_rows] true ADC scores of the stored codes for each query over
    every cell (coarse + residual table sum + bias), -1e30 if absent."""
    c, codes, ids, bias = (a.numpy().astype(np.float64) if a.dtype != torch.uint8 else a.numpy()
                           for a in t.arrays())
    qn = _unit(q).astype(np.float64)
    if t._rot is not None:
        qn = qn @ t._rot.numpy().astype(np.float64)
    books = t._books.numpy().astype(np.float64)
    m, ksub, dsub = books.shape
    table = np.einsum("bmd,mkd->bmk", qn.reshape(len(q), m, dsub), books)
    true = np.full((len(q), t.n_rows), -1e30)
    for cell in range(codes.shape[0]):
        live = ids[cell] >= 0
        if not live.any():
            continue
        adc = table[:, np.arange(m)[:, None], codes[cell][:, live]].sum(axis=1)  # [B, n]
        true[:, ids[cell][live].astype(np.int64)] = (qn @ c[cell])[:, None] + adc + bias[cell][live]
    return true


@pytest.mark.cuda
def test_k8_matches_plain_on_card(cuda_device, ivfpq_state):
    """With and without extents: k = 1, 300 and above pass 2's shared
    memory, nprobe 1 and 6, a cell probed by every query of a batch of
    more than 32."""
    x, t = ivfpq_state
    args = [a.to(cuda_device) for a in t.arrays()] + [t._books.to(cuda_device)]
    c, codes, ids, bias, books = args
    ext = t._extents().to(cuda_device)
    rng = np.random.default_rng(6)
    qn = np.concatenate([x[:300], np.repeat(x[:1], 300, 0)
                         + 0.01 * rng.standard_normal((300, IVF_D)).astype(np.float32)])
    q = torch.from_numpy(_unit(qn)).to(cuda_device)
    true = _adc_judge(t, qn)
    for B, k, nprobe in ((1, 10, 6), (7, 40, 6), (300, 300, 6), (2, 1920, 6), (2, 5000, 6),
                         (600, 1, 6), (600, 40, 1), (520, 300, 6)):
        ps, pi = tivfpq.ivfpq_search(q[:B], c, codes, ids, bias, books, k, nprobe)
        for extents in (ext, None):
            ks, ki = tivfpq.ivfpq_search_cuda(q[:B], c, codes, ids, bias, books, k, nprobe,
                                              extents=extents)
            assert_topk_equiv(ks.cpu(), ki.cpu(), ps.cpu(), pi.cpu(), None, None, None,
                              true=true[:B])


# -- the encoder's tensor-core products and their backward ---------------------

SMALL = dict(vocab_size=512, hidden=64, n_layers=2, n_heads=4, max_len=16)
B_PAIRS, L_PAIRS = 8, 16


def _pair_batch(i, vocab=512):
    """Anchors and positives: the positive is its anchor with a quarter of
    the tokens replaced, so the in-batch accuracy is not trivially 0."""
    r = np.random.default_rng(100 + i)
    a = r.integers(0, vocab, (B_PAIRS, L_PAIRS)).astype(np.int32)
    p = np.where(r.random((B_PAIRS, L_PAIRS)) < 0.25, r.integers(0, vocab, (B_PAIRS, L_PAIRS)),
                 a).astype(np.int32)
    lens = r.integers(4, L_PAIRS + 1, (2, B_PAIRS))
    mask = np.arange(L_PAIRS)[None, None] < lens[..., None]
    return {"anchor_ids": a, "anchor_mask": mask[0], "positive_ids": p, "positive_mask": mask[1]}


def _numpy_params(cfg: EncoderConfig, seed: int = 0) -> dict:
    """f32 parameters from a numpy seed with the port's shapes, norm scales
    and biases away from 1 and 0 (trained weights are)."""
    shapes = {k: v.shape for k, v in init_encoder_params(cfg, torch.Generator()).items()}
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        name = key.rsplit(".", 1)[-1]
        if name.endswith("_scale"):
            v = 1.0 + 0.2 * rng.standard_normal(shape)
        elif name.startswith("b") or name.endswith("_bias"):
            v = 0.1 * rng.standard_normal(shape)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            v = rng.standard_normal(shape) / np.sqrt(fan_in)
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out


@pytest.mark.cuda
def test_tensor_core_backward_matches_cpu(cuda_device):
    """A bf16 step on the card against the CPU route on the same weights."""
    cfg = EncoderConfig(**SMALL, dtype=torch.bfloat16)
    params = _numpy_params(cfg)
    out = {}
    for dev in (CPU, cuda_device):
        p = {k: v.to(dev) for k, v in params.items()}
        _, _, grads = tt._value_and_grad(
            lambda q: tt.info_nce_loss(q, tt._batch_on(_pair_batch(0), dev), cfg, 0.05), p)
        out[dev.type] = {k: g.cpu() for k, g in grads.items()}
    for k, g in out["cpu"].items():
        rel = float((out["cuda"][k] - g).norm() / g.norm().clamp(min=1e-12))
        assert rel < 2e-2, (k, rel)

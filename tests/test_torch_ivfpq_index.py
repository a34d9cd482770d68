"""The port's IVF-PQ (`codegraph_tpu_torch.index.ivfpq`) held to the JAX
package on the CPU.

* The scan: `ivfpq_search` (the plain version of K8) against both
  `ivfpq_search_kernel` (XLA) and `ivfpq_search_pallas` in interpret mode,
  on identical index state: scores within 1e-5 (f32 sums over m subspaces
  taken in another order), ids equal except where the scores tie within
  that bound (duplicate rows of one cell tie exactly).
* The index: state carried over with `IVFPQIndex.load_arrays` (the JAX
  index's cells, codebooks, rotation and refine bank); searches in every
  refine mode, both batch routes, with a filter, and after further adds and
  deletes, held to the same 1e-5 and tie rule. After `add` the codes may
  differ in at most 1 of 1,000 entries (argmin ties in f32: the residual is
  computed in another order), the placements not at all.
* The port's own training reaches the JAX package's recall@10 within 0.05.
K8 itself runs only on a card: `test_k8_matches_plain_on_card` (skips here)
and `chip_smoke.py` hold it to `ivfpq_search`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codegraph_tpu.index import ivfpq as jivfpq
from codegraph_tpu.index.ivfpq import IVFPQIndex as JPQ
from codegraph_tpu_torch.index import ivfpq as tivfpq
from codegraph_tpu_torch.index.ivfpq import IVFPQIndex as TPQ

from tests.test_torch_topk import assert_topk_equiv

D = 32


def _clustered(rng, n, d=D, k=12, spread=0.3, centers=None):
    centers = rng.standard_normal((k, d)) if centers is None else centers
    x = centers[rng.integers(0, len(centers), n)] + spread * rng.standard_normal((n, d))
    return x.astype(np.float32), centers


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def _host(a):
    return None if a is None else np.asarray(a)


def _carried(j, **kw):
    """The port's IVFPQIndex holding exactly the JAX index's state."""
    t = TPQ(j.dim, nlist=j.nlist, nprobe=j.nprobe, m=j.m, refine=j.refine,
            refine_factor=j.refine_factor, capacity_factor=j.capacity_factor, device="cpu", **kw)
    c, codes, ids, bias = j.arrays()
    rows = scales = None
    if j._raw_chunks:
        rows, scales = np.concatenate(j._raw_chunks), np.concatenate(j._raw_scales)
    elif j._dev_chunks:
        rows, scales = (np.asarray(a) for a in j._dev_bank())
    t.load_arrays(_host(c), _host(codes), _host(ids), _host(bias), j._fill, j.list_cap, j.n_rows,
                  j.n_live, books=_host(j._books), rot=_host(j._rot), refine_rows=rows,
                  refine_scales=scales)
    return t


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


def _exact_judge(t, q, rows, scales):
    """[B, n_rows] refined scores: the dot of the refine bank's rows."""
    qn = _unit(q).astype(np.float64)
    if t._rot is not None:
        qn = qn @ t._rot.numpy().astype(np.float64)
    return qn @ (rows.astype(np.float64) * scales).T


@pytest.fixture(scope="module")
def state():
    rng = np.random.default_rng(11)
    x, centers = _clustered(rng, 1200)
    x[600:620] = x[100:120]  # duplicate rows: exact ties inside a cell
    return x, centers


def _trained(x, refine="none", opq=False, **kw):
    j = JPQ(D, nlist=16, nprobe=6, m=8, kmeans_iters=4, pq_iters=4, refine=refine, opq=opq,
            opq_iters=2, **kw)
    j.train(x)
    j.add(x)
    j.delete(np.arange(0, len(x), 29))
    return j


@pytest.mark.parametrize("m,nbits,nprobe,k", [(8, 8, 4, 10), (16, 4, 8, 40), (4, 8, 1, 500),
                                              (8, 2, 16, 7)])
def test_ivfpq_search_matches_jax_kernels(state, m, nbits, nprobe, k):
    """k=500 at nprobe 1 is above the probed cell's live slots: the tail is
    (NEG_INF, -1)."""
    x, _ = state
    rng = np.random.default_rng(m + k)
    j = JPQ(D, nlist=16, nprobe=nprobe, m=m, nbits=nbits, kmeans_iters=3, pq_iters=3)
    j.train(x)
    j.add(x)
    j.delete(np.arange(0, len(x), 31))
    c, codes, ids, bias = (np.asarray(a) for a in j.arrays())
    q = _unit(x[rng.choice(len(x), 5)] + 0.1 * rng.standard_normal((5, D)).astype(np.float32))
    args = (c, codes, ids, bias, np.asarray(j._books))
    xs, xi = jivfpq.ivfpq_search_kernel(jnp.asarray(q), *map(jnp.asarray, args), k, nprobe)
    ps, pi = jivfpq.ivfpq_search_pallas(jnp.asarray(q), *map(jnp.asarray, args), k, nprobe,
                                        interpret=True)
    ts, ti = tivfpq.ivfpq_search(torch.from_numpy(q), *(torch.from_numpy(a.copy()) for a in args),
                                 k, nprobe)
    t = _carried(j)
    true = _adc_judge(t, q)
    assert_topk_equiv(ts, ti, xs, xi, None, None, None, true=true)
    assert_topk_equiv(ts, ti, ps, pi, None, None, None, true=true)
    # the K8 wrapper on CPU tensors is the plain version
    ws, wi = tivfpq.ivfpq_search_cuda(torch.from_numpy(q), *(torch.from_numpy(a.copy())
                                                             for a in args), k, nprobe)
    assert torch.equal(ws, ts) and torch.equal(wi, ti)
    # the wrapper takes the cells' fills as extents; on CPU tensors it runs
    # the plain scan, which reads every slot and ignores them (the kernel's
    # use of them is checked on the card, and the invariant that makes them
    # safe by test_k8_extents_after_add_delete_and_load)
    es, ei = tivfpq.ivfpq_search_cuda(torch.from_numpy(q), *(torch.from_numpy(a.copy())
                                                             for a in args), k, nprobe,
                                      extents=t._extents())
    assert torch.equal(es, ts) and torch.equal(ei, ti)
    if k == 500:
        assert (ti[:, -1] == -1).all() and (ts[:, -1] <= -1e29).all()


@pytest.mark.parametrize("refine", ["none", "int8", "f32", "int8_device"])
@pytest.mark.parametrize("B", [5, 260])
def test_search_on_jax_state_matches_jax(state, refine, B):
    """B=260 takes search_batch on the CPU (batch_share_threshold 256) in
    both packages."""
    x, _ = state
    rng = np.random.default_rng(B)
    j = _trained(x, refine)
    t = _carried(j)
    q = x[rng.choice(len(x), B)] + 0.05 * rng.standard_normal((B, D)).astype(np.float32)
    js, ji = j.search(q, 10)
    ts, ti = t.search(q, 10)
    if refine == "none":
        true = _adc_judge(t, q)
    else:
        rows, scales = (t._raw_chunks[0], t._raw_scales[0]) if t._raw_chunks else \
            (a.numpy() for a in t._dev_bank())
        true = _exact_judge(t, q, rows, scales)
    assert_topk_equiv(ts, ti, js, ji, None, None, None, true=true)
    assert t.stats() == j.stats()


def test_search_batch_matches_search(state):
    x, _ = state
    t = _carried(_trained(x))
    q = x[:20]
    bs, bi = t.search_batch(q, 10)
    ss, si = t.search(q, 10)
    assert_topk_equiv(bs, bi, ss, si, None, None, None, true=_adc_judge(t, q))


@pytest.mark.parametrize("refine", ["none", "int8_device"])
def test_filtered_search_matches_jax(state, refine):
    """A filter that keeps ~3% of rows: the fetch grows 64x (here up to the
    probed capacity), the filter applies after the scan."""
    x, _ = state
    rng = np.random.default_rng(3)
    j = _trained(x, refine)
    t = _carried(j)
    eb = np.full(j.n_rows, -1e30, np.float32)
    eb[rng.choice(j.n_rows, j.n_rows * 3 // 100, replace=False)] = 0.0
    assert tivfpq._filter_fetch_k(10, eb, 10 ** 6) == jivfpq._filter_fetch_k(10, eb, 10 ** 6) == 640
    q = x[rng.choice(len(x), 6)]
    js, ji = j.search(q, 10, extra_bias=eb)
    ts, ti = t.search(q, 10, extra_bias=eb)
    keep = eb > -1e29
    assert all(keep[i] for i in ti.ravel() if i >= 0)
    true = _adc_judge(t, q) if refine == "none" else \
        _exact_judge(t, q, *(a.numpy() for a in t._dev_bank()))
    true[:, ~keep] = -1e30
    assert_topk_equiv(ts, ti, js, ji, None, None, None, true=true)


@pytest.mark.parametrize("refine", ["none", "int8", "int8_device"])
def test_add_delete_search_match_jax(state, refine):
    """More adds after the carried training: same placements, codes within
    1 in 1,000, the same refine banks, the same answers."""
    x, centers = state
    rng = np.random.default_rng(5)
    j = JPQ(D, nlist=16, nprobe=6, m=8, kmeans_iters=4, pq_iters=4, refine=refine,
            capacity_factor=1.2)
    j.train(x)
    t = TPQ(D, nlist=16, nprobe=6, m=8, refine=refine, capacity_factor=1.2, device="cpu")
    t._centroids = torch.from_numpy(np.asarray(j._centroids).copy())
    t._books = torch.from_numpy(np.asarray(j._books).copy())
    extra, _ = _clustered(rng, 300, centers=centers[:3])
    for chunk in (x[:700], x[700:], extra):
        assert np.array_equal(j.add(chunk), t.add(chunk))
    assert j.list_cap == t.list_cap and np.array_equal(j._fill, t._fill)
    assert all(j._row_loc[r] == tuple(t._row_loc[r]) for r in range(j.n_rows))
    jc, tc = np.asarray(j.arrays()[1]), t.arrays()[1].numpy()
    assert (jc != tc).mean() <= 1e-3
    if refine == "int8":
        assert np.abs(np.concatenate(t._raw_chunks).astype(int)
                      - np.concatenate(j._raw_chunks)).max() <= 1
    dead = rng.choice(j.n_rows, 80, replace=False)
    j.delete(dead)
    t.delete(dead)
    assert len(t) == len(j)
    # answers on identical state (the codes as the JAX index holds them)
    t2 = _carried(j)
    q = x[rng.choice(len(x), 7)]
    js, ji = j.search(q, 10)
    ts, ti = t2.search(q, 10)
    true = _adc_judge(t2, q) if refine == "none" else _exact_judge(
        t2, q, *((t2._raw_chunks[0], t2._raw_scales[0]) if t2._raw_chunks
                 else (a.numpy() for a in t2._dev_bank())))
    assert_topk_equiv(ts, ti, js, ji, None, None, None, true=true)


def test_opq_state_matches_jax(state):
    x, _ = state
    j = _trained(x, opq=True)
    t = _carried(j)
    assert t._rot is not None and t.stats()["opq"]
    q = x[:6]
    js, ji = j.search(q, 10)
    ts, ti = t.search(q, 10)
    assert_topk_equiv(ts, ti, js, ji, None, None, None, true=_adc_judge(t, q))


@pytest.mark.parametrize("refine,opq", [("none", False), ("int8", False), ("none", True)])
def test_own_training_recall_close_to_jax(refine, opq):
    rng = np.random.default_rng(21)
    d = 48
    x, centers = _clustered(rng, 2000, d=d, k=32, spread=0.3)
    q, _ = _clustered(rng, 60, d=d, centers=centers, spread=0.3)
    exact = np.argsort(-(_unit(q) @ _unit(x).T), axis=1)[:, :10]

    def recall(idx):
        idx.train(x)
        idx.add(x)
        _, got = idx.search(q, 10)
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(got, exact)])

    kw = dict(nlist=32, nprobe=8, m=12, kmeans_iters=8, pq_iters=8, refine=refine, opq=opq,
              opq_iters=3)
    r_j = recall(JPQ(d, **kw))
    r_t = recall(TPQ(d, device="cpu", **kw))
    assert r_t >= r_j - 0.05 and r_t > 0.3


def test_tiny_corpus_shrinks_codebooks_like_jax():
    """Fewer training rows than 2^nbits: ksub shrinks to fit, in both."""
    rng = np.random.default_rng(2)
    x, _ = _clustered(rng, 100)
    j = JPQ(D, nlist=4, nprobe=4, m=8, kmeans_iters=2, pq_iters=2)
    t = TPQ(D, nlist=4, nprobe=4, m=8, kmeans_iters=2, pq_iters=2, device="cpu")
    j.train(x)
    t.train(x)
    assert t._books.shape == np.asarray(j._books).shape == (8, 64, 4)


def test_refine_device_tiled_matches_jax():
    rng = np.random.default_rng(4)
    B, R, n = 3, 300, 500
    raw = rng.integers(-127, 128, (n, D)).astype(np.int8)
    scales = rng.random((n, 1)).astype(np.float32) / 127
    q = _unit(rng.standard_normal((B, D)).astype(np.float32))
    cand = rng.integers(-1, n, (B, R)).astype(np.int32)
    s = np.zeros((B, R), np.float32)
    js, ji = jivfpq._refine_device_tiled(jnp.asarray(q), jnp.asarray(raw), jnp.asarray(scales),
                                         jnp.asarray(s), jnp.asarray(cand), 20)
    ts, ti = tivfpq._refine_device_tiled(torch.from_numpy(q), torch.from_numpy(raw),
                                         torch.from_numpy(scales), torch.from_numpy(s),
                                         torch.from_numpy(cand), 20)
    fs, fi = tivfpq._refine_device_kernel(torch.from_numpy(q), torch.from_numpy(raw),
                                          torch.from_numpy(scales), torch.from_numpy(s),
                                          torch.from_numpy(cand), 20)
    true = np.full((B, n), -1e30)
    true[:, :] = q.astype(np.float64) @ (raw.astype(np.float64) * scales).T
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_allclose(fs.numpy(), ts.numpy(), rtol=0, atol=1e-6)
    for b in range(B):  # an id that differs must score the same (candidates repeat)
        for p in np.nonzero(ti[b].numpy() != np.asarray(ji)[b])[0]:
            assert abs(true[b, ti[b, p]] - float(np.asarray(js)[b, p])) <= 1e-5


def test_device_bank_preallocated_matches_append(state):
    x, _ = state
    a = TPQ(D, nlist=8, nprobe=8, m=8, kmeans_iters=3, pq_iters=3, refine="int8_device",
            device="cpu")
    a.train(x)
    b = TPQ(D, nlist=8, nprobe=8, m=8, refine="int8_device", device="cpu")
    b._centroids, b._books = a._centroids.clone(), a._books.clone()
    b.reserve(400)  # too small at first: grows in place
    for chunk in (x[:300], x[300:]):
        a.add(chunk)
        b.add(chunk)
    assert b._dev_prealloc and len(b._dev_chunks) == 1 and b._dev_chunks[0].shape[0] >= 1200
    ra, sa = a._dev_bank()
    np.testing.assert_array_equal(b._dev_chunks[0][:1200].numpy(), ra.numpy())
    np.testing.assert_array_equal(b._dev_scales[0][:1200].numpy(), sa.numpy())
    sa_, ia_ = a.search(x[:4], 5)
    sb_, ib_ = b.search(x[:4], 5)
    np.testing.assert_array_equal(ia_, ib_)


@pytest.mark.parametrize("B,nprobe,cap,k,want", [
    (1, 64, 4992, 40, 156),     # one query fills the card: one split a 2048-slot tile
    (8, 64, 4992, 40, 33),      # one wave: 8 x 33 blocks at two an SM
    (1024, 64, 4992, 300, 1),   # many queries: one split each
    (1, 64, 4992, 1920, 156),   # a filtered fetch above 1,024
    (1, 64, 4992, 5000, 1),     # k above pass 2's shared memory: one split
    (3, 1, 128, 10, 1),
])
def test_k8_plan_covers_every_slot(B, nprobe, cap, k, want):
    """The query-major plan, and the kernel's division of a query's live
    slots (adc_qmajor: ranges of ceil(total / 8 / splits) groups of 8)
    covers every live slot once, for any total up to the capacity."""
    splits = tivfpq.adc_plan(B, nprobe, cap, k)
    assert splits == want
    assert B * splits <= tivfpq.QMAJOR_MAX_BLOCKS * tivfpq.SM_COUNT or splits == 1
    assert splits == 1 or k <= tivfpq.MERGE_MAX_K
    rng = np.random.default_rng(B + k)
    for total in {0, 8, nprobe * cap, *(8 * rng.integers(0, nprobe * cap // 8, 5))}:
        per = -(-(total // 8) // splits) * 8
        covered = [(min(total, s * per), min(total, min(total, s * per) + per))
                   for s in range(splits)]
        assert covered[0][0] == 0 and covered[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))


def test_k8_shared_memory_plan():
    """The query-major block stages the table when it fits and never holds
    a list, so its shared memory (and two blocks an SM) does not depend on
    k; a table too large to stage is read from device memory."""
    for k in (40, 126, 127, 300, 1920, 20000):
        splits, table, blocks = tivfpq.adc_qmajor_plan(1, 64, 96, 256, 4992, k)
        assert (table, blocks) == (1, 2) and splits == (156 if k <= tivfpq.MERGE_MAX_K else 1)
    assert tivfpq.adc_qmajor_plan(1, 64, 384, 256, 4992, 40)[1:] == (0, 2)
    assert tivfpq.qmajor_smem(96, 256, 64, 1) == 96 * 256 * 4 + 129 * 4 + 16 * 32 * 8 + 16 * 12


@pytest.mark.parametrize("k", [40, 126, 127, 300, 1920])
def test_k8_blocks_per_sm_fit_at_every_k(k):
    """The planned blocks fit an SM at once at every k: two blocks at the
    phase-7 shape, the splits of one query in one wave; the lists and the
    candidate buffers take no shared memory that grows with k."""
    splits, table, blocks = tivfpq.adc_qmajor_plan(1, 64, 96, 256, 4992, k)
    smem = tivfpq.qmajor_smem(96, 256, 64, table)
    assert blocks == 2 and blocks * (smem + tivfpq.BLOCK_SMEM_RESERVED) <= tivfpq.SM_SMEM
    assert 1 * splits <= blocks * tivfpq.SM_COUNT


def _assert_extent_invariant(t):
    ext = t._extents().numpy()
    _, _, ids, bias = (a.numpy() for a in t.arrays())
    assert ext.shape == (t.nlist,) and ext.dtype == np.int32
    assert (ext <= t.list_cap).all()
    past = np.arange(t.list_cap)[None, :] >= ext[:, None]
    assert (ids[past] == -1).all() and (bias[past] <= -1e29).all()
    assert (ids[~past] >= 0).all()  # live or tombstoned: the rows stay below the fill
    assert int(ext.sum()) == int((ids >= 0).sum())


def test_k8_extents_after_add_delete_and_load(state):
    """The extents K8 scans up to are each cell's fill: every slot past it
    is padding (id -1, bias NEG_INF), after adds (with a cell growth),
    deletes (a tombstone keeps its slot), and a JAX index's arrays."""
    x, centers = state
    j = _trained(x)
    t = _carried(j)
    _assert_extent_invariant(t)
    np.testing.assert_array_equal(t._extents().numpy(), np.minimum(j._fill[: j.nlist], j.list_cap))
    cap0 = t.list_cap
    rng = np.random.default_rng(8)
    extra, _ = _clustered(rng, 2000, centers=centers[:2])
    t.add(extra)
    assert t.list_cap > cap0
    _assert_extent_invariant(t)
    t.delete(rng.choice(t.n_rows, 100, replace=False))
    _assert_extent_invariant(t)


def test_k8_extents_with_fill_longer_than_nlist(state):
    """`_fill` may be longer than nlist (the indexer's nlist shrink): the
    extents take its first nlist entries."""
    x, _ = state
    j = _trained(x)
    t = TPQ(D, nlist=j.nlist, nprobe=j.nprobe, m=j.m, device="cpu")
    c, codes, ids, bias = (np.asarray(a) for a in j.arrays())
    fill = np.concatenate([j._fill[: j.nlist], np.full(48, 3, np.int64)])
    t.load_arrays(c, codes, ids, bias, fill, j.list_cap, j.n_rows, j.n_live,
                  books=np.asarray(j._books))
    assert t._extents().shape == (j.nlist,)
    _assert_extent_invariant(t)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the K8 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k8_matches_plain_on_card(cuda_device, state):
    """With and without extents: k = 1, 300 and above pass 2's shared
    memory, nprobe 1 and 6, a cell probed by every query of a batch of
    more than 32."""
    x, _ = state
    t = _carried(_trained(x))
    args = [a.to(cuda_device) for a in t.arrays()] + [t._books.to(cuda_device)]
    c, codes, ids, bias, books = args
    ext = t._extents().to(cuda_device)
    rng = np.random.default_rng(6)
    qn = np.concatenate([x[:300], np.repeat(x[:1], 300, 0)
                         + 0.01 * rng.standard_normal((300, D)).astype(np.float32)])
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


def _variants_tool():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                        "ivfpq_adc_variants.py")
    spec = importlib.util.spec_from_file_location("ivfpq_adc_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(_variants_tool().VARIANTS))
def test_k8_variant_tool_anchors_in_source(name):
    """Every text change of tools/ivfpq_adc_variants.py still applies to
    csrc/ivfpq_adc.cu, every index/ivfpq.py constant it sets exists, and
    every call keyword is one the wrapper takes."""
    from codegraph_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "ivfpq_adc.cu").read_text()
    subs, consts, call, _ = _variants_tool().VARIANTS[name]
    for anchor, _ in subs:
        assert anchor in src
    for const in consts:
        assert hasattr(tivfpq, const)
    assert set(call) <= {"extents"}


def test_k8_profile_anchors_in_source():
    """The clock64 stamps of tools/ivfpq_adc_variants.py --profile each
    apply once to csrc/ivfpq_adc.cu."""
    from codegraph_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC_DIR / "ivfpq_adc.cu").read_text()
    for anchor, _ in _variants_tool().PROFILE:
        assert src.count(anchor) == 1, anchor


@pytest.mark.parametrize("bad,err", [
    (dict(codes_dtype=torch.int32), "uint8 codes"), (dict(cap=12), "cap % 8"),
    (dict(ksub=24), "power of"), (dict(noncontig=True), "contiguous"),
    (dict(offset=True), "aligned"), (dict(ids_shape=(4, 8)), "shape mismatch"), (dict(k=0), "k=0"),
])
def test_k8_input_checks(bad, err):
    nlist, m, cap, ksub = 4, 2, bad.get("cap", 16), bad.get("ksub", 16)
    codes = torch.zeros((nlist, m, cap), dtype=bad.get("codes_dtype", torch.uint8))
    if bad.get("noncontig"):
        codes = torch.zeros((nlist, cap, m), dtype=torch.uint8).transpose(1, 2)
    if bad.get("offset"):
        codes = torch.zeros(nlist * m * cap + 1, dtype=torch.uint8)[1:].view(nlist, m, cap)
    ids = torch.zeros(bad.get("ids_shape", (nlist, cap)), dtype=torch.int32)
    bias = torch.zeros((nlist, cap))
    books = torch.zeros((m, ksub, 4))
    with pytest.raises(ValueError, match=err):
        tivfpq._check_adc(codes, ids, bias, books, bad.get("k", 10))

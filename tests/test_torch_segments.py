"""The port's `SegmentedIndex` (`codegraph_tpu_torch/index/segments.py`),
held to the JAX package's on the CPU.

Both are fed the same seeded numpy rows in the same appends. The JAX
segments search with their Pallas kernels in interpret mode (the backend
the JAX package picks on a TPU; on the CPU it would pick its XLA scan,
which does not round a bf16 index's queries to bf16 as the kernels and
the port do). Tolerances:
rows, seals, stats and compaction's row map are equal exactly; searches
equal in ids (each segment's flat scan is held to the JAX one in
`tests/test_torch_flat_index.py`; a differing id is allowed only where the
scores tie within TOL) with scores within TOL = 1e-5 (f32 sums in another
order). The host merge is the reference's code, so equal per-segment
results merge to equal results.
"""

import numpy as np
import pytest

from codegraph_tpu.core.types import CodeChunk as JChunk
from codegraph_tpu.graph.store import GraphStore as JStore
from codegraph_tpu.index.segments import SegmentedIndex as JSeg
from codegraph_tpu.indexer.writer import WriterHandle as JWriter
from codegraph_tpu_torch.core.types import CodeChunk as TChunk
from codegraph_tpu_torch.graph.store import GraphStore as TStore
from codegraph_tpu_torch.index import SegmentedIndex as TSeg
from codegraph_tpu_torch.indexer.writer import WriterHandle as TWriter

TOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_segments_on_their_kernels(monkeypatch):
    import codegraph_tpu.index.flat as jflat

    monkeypatch.setattr(jflat, "_default_backend", lambda: "pallas")


def _pair(dim, **kw):
    return JSeg(dim, **kw), TSeg(dim, device="cpu", **kw)


def _assert_search_equal(j, t, q, k):
    js, ji = j.search(q, k)
    ts, ti = t.search(q, k)
    assert ts.shape == js.shape == (q.shape[0], k) and ti.dtype == np.int64
    live = js > -1e29
    np.testing.assert_array_equal(ts > -1e29, live)
    np.testing.assert_array_equal(ti[~live], -1)
    np.testing.assert_allclose(ts[live], js[live], rtol=0, atol=TOL)
    for b, pos in zip(*np.nonzero(ti != ji)):
        near = [abs(js[b, n] - js[b, pos]) for n in (pos - 1, pos + 1) if 0 <= n < k]
        assert min(near) <= TOL, (b, pos)


def _stats(idx):
    return [(s.segment_id, s.sealed, s.rows, s.live) for s in idx.stats()]


def _fill(j, t, x, cuts):
    rows = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        rj, rt = j.add(x[a:b]), t.add(x[a:b])
        np.testing.assert_array_equal(rt, rj)
        rows.append(rj)
    return np.concatenate(rows)


@pytest.mark.parametrize("dtype,metric", [("float32", "cosine"), ("bfloat16", "cosine"),
                                          ("float32", "dot")])
@pytest.mark.parametrize("B", [1, 5, 40])
def test_add_seal_search_equal(dtype, metric, B):
    rng = np.random.default_rng(0)
    D, k = 24, 8
    j, t = _pair(D, dtype=dtype, metric=metric, seal_threshold=60)
    x = rng.standard_normal((250, D)).astype(np.float32)
    _fill(j, t, x, [0, 50, 130, 200, 250])  # 130 and 200 cross the threshold
    assert _stats(t) == _stats(j) and len(t) == len(j) == 250
    assert sum(s.sealed for s in t.stats()) >= 2
    q = rng.standard_normal((B, D)).astype(np.float32)
    _assert_search_equal(j, t, q, k)
    _assert_search_equal(j, t, x[:B], k)  # self-hits across the segment bounds


def test_k_above_live_rows_pads_like_jax():
    rng = np.random.default_rng(1)
    j, t = _pair(16, seal_threshold=4)
    x = rng.standard_normal((7, 16)).astype(np.float32)
    _fill(j, t, x, [0, 3, 5, 7])
    _assert_search_equal(j, t, rng.standard_normal((3, 16)).astype(np.float32), 12)
    ts, ti = t.search(x[:1], 12)
    assert (ti[0, 7:] == -1).all()


def test_empty_index_searches_like_jax():
    j, t = _pair(8)
    _assert_search_equal(j, t, np.ones((2, 8), np.float32), 3)


@pytest.mark.parametrize("compact_min", [2, 4])
def test_delete_seal_and_compact_equal(compact_min):
    rng = np.random.default_rng(2)
    D = 16
    j, t = _pair(D, seal_threshold=50, compact_min_segments=compact_min)
    x = rng.standard_normal((180, D)).astype(np.float32)
    rows = _fill(j, t, x, [0, 50, 100, 140, 160, 180])
    dead = rows[rng.permutation(len(rows))[:45]]
    j.delete(dead)
    t.delete(dead)
    assert len(t) == len(j) == 135 and _stats(t) == _stats(j)
    _assert_search_equal(j, t, x[:6], 5)
    assert t.should_compact() == j.should_compact()
    remap_j, remap_t = j.compact(), t.compact()
    assert remap_t == remap_j and len(remap_t) > 0
    assert all(type(k_) is int and type(v) is int for k_, v in remap_t.items())
    assert _stats(t) == _stats(j) and len(t) == len(j)
    _assert_search_equal(j, t, x[100:110], 5)
    # a survivor is found at its new row
    live = [r for r in rows[:100] if r not in set(dead.tolist())]
    s, i = t.search(x[np.searchsorted(rows, live[:3])], 1)
    np.testing.assert_array_equal(i[:, 0], [remap_t[int(r)] for r in live[:3]])
    # appends after compaction go to the tail and search equally
    _fill(j, t, rng.standard_normal((30, D)).astype(np.float32), [0, 30])
    _assert_search_equal(j, t, x[:4], 7)


def test_compact_with_fewer_than_two_sealed_is_a_no_op():
    rng = np.random.default_rng(3)
    j, t = _pair(8, seal_threshold=10)
    _fill(j, t, rng.standard_normal((12, 8)).astype(np.float32), [0, 12])
    assert t.compact() == j.compact() == {}
    assert _stats(t) == _stats(j)


def test_cuda_without_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is no refusal there")
    with pytest.raises(RuntimeError, match="cuda"):
        TSeg(8)


def _writer_run(store_cls, chunk_cls, seg, writer_cls, x, per_job):
    store = store_cls()
    w = writer_cls(store, seg)
    for n, a in enumerate(range(0, len(x), per_job)):
        chunks = [chunk_cls.make(f"n{n}_{i}", f"chunk {a + i}", 0, 1)
                  for i in range(min(per_job, len(x) - a))]
        w.enqueue_chunk_embeddings(chunks, x[a:a + per_job])
    errors = w.flush()
    w.close()
    return errors, store.stats(), w.stats.applied, w.stats.failed


def test_writer_over_segments_drifts_like_jax():
    """The reference's writer checks that the index returns the store's rows;
    a SegmentedIndex returns segment-strided rows from its second segment on,
    so every later job is applied and then reported as a row drift, in both
    packages (ROADMAP queue 3)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((90, 12)).astype(np.float32)
    j, t = _pair(12, seal_threshold=30)
    want = _writer_run(JStore, JChunk, j, JWriter, x, 30)
    got = _writer_run(TStore, TChunk, t, TWriter, x, 30)
    assert got == want
    assert len(got[0]) == 2 and all("row drift" in e for e in got[0])
    assert len(t) == len(j) == 90 and _stats(t) == _stats(j)
    _assert_search_equal(j, t, x[:5], 4)

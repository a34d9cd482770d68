"""The port's shared-memory hand-off (`codegraph_tpu_torch/core/shm.py`, the
shm half of `index/snapshot.py`, `search/service.py` ShmServedIndex) on
the CPU: the cases of tests/test_shm.py run on the port, then the two
packages against each other.

* Segment bytes: for the same arrays (bf16 included: an ml_dtypes array on
  the JAX side, a torch.bfloat16 tensor on the port's) both packages
  write the same file, header and payload, byte for byte.
* Indexes published by one package and attached by the other (flat f32
  and bf16, int8 with its rescore copy, IVF-PQ with codes, books, OPQ
  rotation and refine rows) search like the publisher's own index: scores
  within 1e-5, ids equal except where the scores tie within that bound
  (tests/test_torch_topk.assert_topk_equiv, judged on the attached state).
* ShmServedIndex in a second process (a subprocess, CPU) reloads on a
  republish and on a recreated segment (new inode) and answers like the
  publisher's index each time.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from codegraph_tpu.core import shm as jshm
from codegraph_tpu.index import snapshot as jsnap
from codegraph_tpu.index.flat import FlatIndex as JFlat
from codegraph_tpu.index.int8_flat import Int8FlatIndex as JInt8
from codegraph_tpu_torch.core.errors import SnapshotError
from codegraph_tpu_torch.core.shm import (
    SharedArrayStore,
    SharedMemoryManager,
    SharedSegment,
    ShmError,
)
from codegraph_tpu_torch.index import snapshot as tsnap
from codegraph_tpu_torch.index.flat import FlatIndex
from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex
from codegraph_tpu_torch.index.ivfpq import IVFPQIndex
from codegraph_tpu_torch.search.service import QueryService, ShmServedIndex

from tests import test_torch_flat_index as tflat
from tests import test_torch_int8_index as tint8
from tests import test_torch_ivfpq_index as tivfpq
from tests.test_torch_topk import assert_topk_equiv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


# -- the cases of tests/test_shm.py, on the port -----------------------------


def test_segment_roundtrip_and_generation(tmp_path):
    p = str(tmp_path / "seg.shm")
    with SharedSegment.create(p, 1024) as seg:
        assert seg.generation == 1
        seg.write(b"hello shared world")
        assert seg.generation == 2
        assert seg.read() == b"hello shared world"
        seg.write(b"second")
        assert seg.generation == 4 and seg.is_updated_since(2)
        st = seg.stats()
        assert st.payload_len == 6 and st.capacity == 1024


def test_segment_capacity_readonly_missing_and_bad_magic(tmp_path):
    p = str(tmp_path / "seg.shm")
    with SharedSegment.create(p, 16) as seg:
        with pytest.raises(ShmError):
            seg.write(b"x" * 17)
        seg.write(b"ok")
    with SharedSegment.open(p) as ro:
        assert ro.read() == b"ok"
        with pytest.raises(ShmError):
            ro.write(b"nope")
    with pytest.raises(ShmError):
        SharedSegment.open(str(tmp_path / "absent.shm"))
    bad = tmp_path / "bad.shm"
    bad.write_bytes(b"\0" * 64)
    with pytest.raises(ShmError):
        SharedSegment.open(str(bad))


def test_array_store_zero_copy_views(tmp_path):
    p = str(tmp_path / "arrays.shm")
    arrays = {"x": np.arange(24, dtype=np.float32).reshape(4, 6),
              "ids": np.array([7, 8, 9], dtype=np.int64),
              "blob": np.frombuffer(b"meta", np.uint8)}
    with SharedArrayStore.create(p, arrays) as store:
        got = store.arrays(copy=False)
        for k in arrays:
            np.testing.assert_array_equal(got[k], arrays[k])
        assert not got["x"].flags.owndata
        for k in ("x", "ids"):
            assert got[k].ctypes.data % 64 == 0
    with SharedArrayStore.open(p) as store:
        snap = store.arrays(copy=True)
    np.testing.assert_array_equal(snap["x"], arrays["x"])


@pytest.mark.parametrize("copy", [False, True])
def test_array_store_bf16_tensor_without_ml_dtypes(tmp_path, copy):
    """A bf16 entry reads back as a torch.bfloat16 tensor through uint16."""
    p = str(tmp_path / "bf16.shm")
    x = torch.arange(8, dtype=torch.float32).bfloat16() / 3
    with SharedArrayStore.create(p, {"x": x}) as store:
        got = store.arrays(copy=copy)["x"]
        assert got.dtype == torch.bfloat16 and torch.equal(got, x)
        if not copy:  # a view of the shared pages, at its aligned offset
            assert got.data_ptr() % 64 == 0


def test_array_store_republish_and_manager(tmp_path):
    p = str(tmp_path / "re.shm")
    with SharedArrayStore.create(p, {"v": np.zeros(8, np.float32)}, slack=1.0) as store:
        g0 = store.generation
        store.publish({"v": np.ones(16, np.float32)})
        assert store.generation > g0
        np.testing.assert_array_equal(store.arrays()["v"], np.ones(16, np.float32))
    mgr = SharedMemoryManager(str(tmp_path / "segs"))
    for name in ("alpha", "beta"):
        with mgr.get_or_create(name, 256) as seg:
            seg.write(name[:1].encode())
    assert mgr.list_segments() == ["alpha", "beta"]
    assert {s.name for s in mgr.all_stats()} == {"alpha.shm", "beta.shm"}
    with mgr.get_or_create("alpha", 256) as seg:  # reattach keeps content
        assert seg.read() == b"a"
        g0 = seg.generation
    with mgr.get_or_create("alpha", 4096) as seg:  # grows in place
        assert seg.capacity >= 4096 and seg.generation >= g0
        seg.write(b"y" * 4096)
        assert seg.read() == b"y" * 4096
    mgr.remove("alpha")
    with pytest.raises(ShmError):
        mgr.open("../evil")
    assert mgr.cleanup_unused(max_age_s=0.0) == 1 and mgr.list_segments() == []


def _port_flat(rows, dim=24, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    idx = FlatIndex(dim, dtype=dtype, device=CPU)
    idx.add(rng.standard_normal((rows, dim)).astype(np.float32))
    return idx


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_index_publish_attach(tmp_path, dtype):
    idx = _port_flat(200, 32, dtype=dtype)
    q = np.random.default_rng(1).standard_normal((5, 32)).astype(np.float32)
    s_ref, i_ref = idx.search(q, 7)
    pub = tsnap.publish_flat_shm(idx, str(tmp_path / "flat.shm"))
    attached, store = tsnap.attach_flat_shm(pub.segment.path, device=CPU)
    s2, i2 = attached.search(q, 7)
    np.testing.assert_array_equal(i2, i_ref)
    np.testing.assert_array_equal(s2, s_ref)
    assert len(attached) == len(idx) and attached.dtype == idx.dtype
    store.close()
    pub.close()


def test_publish_republish_monotonic_generation(tmp_path):
    p = str(tmp_path / "serve.shm")
    s1 = tsnap.publish_flat_shm(_port_flat(50), p)
    g1 = s1.generation
    s1.close()
    s2 = tsnap.publish_flat_shm(_port_flat(60, seed=1), p)
    assert s2.generation > g1
    s2.close()


def test_shm_served_index_hot_reload_and_recreate(tmp_path):
    p = str(tmp_path / "serve.shm")
    idx1 = _port_flat(40, seed=2)
    pub = tsnap.publish_flat_shm(idx1, p, slack=0.0)
    served = ShmServedIndex(p, check_every=0.0, device=CPU)
    _, rows = served.search(idx1.get_vectors(np.arange(3)), 1)
    np.testing.assert_array_equal(rows[:, 0], np.arange(3))
    g0 = served.generation
    # 500 rows outgrow the slack-free segment: recreated in place, same inode
    pub2 = tsnap.publish_flat_shm(_port_flat(500, seed=3), p)
    assert pub2.generation > g0 and served.maybe_reload() and len(served) == 500
    # removed and published again: a new inode, the generation restarts
    pub.close()
    pub2.close()
    os.unlink(p)
    idx3 = _port_flat(80, seed=5)
    pub3 = tsnap.publish_flat_shm(idx3, p)
    assert served.maybe_reload() and len(served) == 80 and served.reloads == 3
    _, rows = served.search(idx3.get_vectors(np.arange(4)), 1)
    np.testing.assert_array_equal(rows[:, 0], np.arange(4))
    assert not served.maybe_reload()  # nothing new
    pub3.close()
    served.close()


def test_shm_served_index_keeps_serving_when_the_segment_is_gone(tmp_path):
    p = str(tmp_path / "serve.shm")
    pub = tsnap.publish_flat_shm(_port_flat(30), p)
    served = ShmServedIndex(p, check_every=0.0, device=CPU)
    pub.close()
    os.unlink(p)
    assert not served.maybe_reload() and len(served) == 30
    with open(p, "wb") as f:  # a foreign file where the segment was
        f.write(b"\0" * 128)
    assert not served.maybe_reload() and len(served) == 30
    served.close()


def test_query_service_over_shm_served(tmp_path):
    p = str(tmp_path / "serve.shm")
    idx = _port_flat(64, seed=6)
    pub = tsnap.publish_flat_shm(idx, p)
    served = ShmServedIndex(p, check_every=0.0, device=CPU)
    svc = QueryService(served, k=1, max_batch=8, max_wait_ms=10.0)
    futs = [svc.submit(idx.get_vectors(np.array([i]))[0]) for i in range(8)]
    assert [f.result(timeout=30)[1][0] for f in futs] == list(range(8))
    svc.close()
    pub.close()
    served.close()


def test_int8_index_publish_attach_hot_reload(tmp_path):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((120, 32)).astype(np.float32)
    idx = Int8FlatIndex(32, rescore_dtype="bfloat16", rescore_k=16, device=CPU)
    idx.add(x)
    q = x[:5] + 0.01
    s_ref, i_ref = idx.search(q, 5)
    p = str(tmp_path / "int8.shm")
    pub = tsnap.publish_index_shm(idx, p)
    served = ShmServedIndex(p, check_every=0.0, device=CPU)
    s2, i2 = served.search(q, 5)
    np.testing.assert_array_equal(i2, i_ref)
    np.testing.assert_array_equal(s2, s_ref)
    idx.add(rng.standard_normal((40, 32)).astype(np.float32))
    pub2 = tsnap.publish_index_shm(idx, p)
    assert served.maybe_reload() and len(served) == 160
    assert served._idx.rescore_dtype == torch.bfloat16
    pub.close()
    pub2.close()
    served.close()


def _port_ivfpq(rows=256, dim=32, seed=0, refine="int8", opq=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, dim)).astype(np.float32)
    idx = IVFPQIndex(dim, nlist=8, nprobe=8, m=8, refine=refine, kmeans_iters=4, pq_iters=4,
                     train_sample=rows, opq=opq, opq_iters=2, device=CPU)
    idx.train(x)
    idx.add(x)
    return idx, x


@pytest.mark.parametrize("refine,opq", [("int8", False), ("int8_device", True), ("none", False)])
def test_ivfpq_publish_attach_identical_results(tmp_path, refine, opq):
    idx, x = _port_ivfpq(refine=refine, opq=opq)
    idx.delete(np.arange(0, 256, 17))
    q = np.random.default_rng(1).standard_normal((4, 32)).astype(np.float32)
    s_ref, i_ref = idx.search(q, 5)
    pub = tsnap.publish_index_shm(idx, str(tmp_path / "ivfpq.shm"))
    attached, store = tsnap.attach_index_shm(pub.segment.path, device=CPU)
    assert type(attached).__name__ == "IVFPQIndex" and attached.refine == refine
    assert (attached._rot is not None) == opq
    assert torch.equal(attached._extents(), idx._extents())
    s2, i2 = attached.search(q, 5)
    np.testing.assert_array_equal(i2, i_ref)
    np.testing.assert_array_equal(s2, s_ref)
    assert len(attached) == len(idx)
    with pytest.raises(KeyError):  # a read-only replica: deletes belong to the publisher
        attached.delete([3])
    store.close()
    pub.close()


def test_unsupported_kind_raises(tmp_path):
    from codegraph_tpu_torch.index.ivf import IVFIndex

    ivf = IVFIndex(16, nlist=4, device=CPU)
    with pytest.raises(SnapshotError):
        tsnap.publish_index_shm(ivf, str(tmp_path / "ivf.shm"))
    p = str(tmp_path / "other.shm")
    meta = np.frombuffer(json.dumps({"kind": "ivf"}).encode(), np.uint8)
    SharedArrayStore.create(p, {"_meta": meta}).close()
    with pytest.raises(SnapshotError):
        tsnap.attach_index_shm(p, device=CPU)


def test_cuda_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    pub = tsnap.publish_flat_shm(_port_flat(20), str(tmp_path / "flat.shm"))
    with pytest.raises(RuntimeError, match="cuda"):
        tsnap.attach_index_shm(pub.segment.path)
    with pytest.raises(RuntimeError, match="cuda"):
        ShmServedIndex(pub.segment.path)
    pub.close()


# -- across the two packages ---------------------------------------------------


def test_segment_bytes_equal_across_packages(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(4)
    x = rng.standard_normal((33, 7)).astype(np.float32)
    common = {"f32": x, "i8": (x * 40).astype(np.int8), "u8": np.arange(5, dtype=np.uint8),
              "i64": np.arange(9, dtype=np.int64), "scalar": np.asarray(3.5, np.float32)}
    jarrs = dict(common, bf16=x.astype(ml_dtypes.bfloat16))
    tarrs = dict(common, bf16=torch.from_numpy(x).bfloat16())
    assert bytes(jarrs["bf16"].view(np.uint16)) == bytes(tarrs["bf16"].view(torch.int16).numpy())
    pj, pt = str(tmp_path / "j.shm"), str(tmp_path / "t.shm")
    jshm.SharedArrayStore.create(pj, jarrs, slack=0.25).close()
    SharedArrayStore.create(pt, tarrs, slack=0.25).close()
    assert open(pj, "rb").read() == open(pt, "rb").read()


def _pallas(j):
    """The JAX flat index searched through its Pallas kernel (interpret
    mode here), the function the port's kernels implement; its CPU default,
    the XLA scan, rounds bf16 products otherwise."""
    j.backend = "pallas"
    return j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [3, 40])
def test_flat_published_by_jax_attached_by_port(tmp_path, rng, dtype, B):
    j = _pallas(JFlat(64, dtype=dtype))
    j.add(rng.standard_normal((300, 64)).astype(np.float32))
    j.delete(np.arange(0, 300, 13))
    pub = jsnap.publish_index_shm(j, str(tmp_path / "j.shm"))
    t, store = tsnap.attach_index_shm(pub.segment.path, copy=True, device=CPU)
    assert t.dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
    assert (t.n_rows, t.n_live) == (j.n_rows, j.n_live)
    tflat._assert_same(j, t, rng.standard_normal((B, 64)).astype(np.float32), 10)
    store.close()
    pub.close()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_published_by_port_attached_by_jax(tmp_path, rng, dtype):
    t = _port_flat(300, 64, seed=8, dtype=dtype)
    t.delete(np.arange(0, 300, 11))
    pub = tsnap.publish_index_shm(t, str(tmp_path / "t.shm"))
    j, store = jsnap.attach_index_shm(pub.segment.path, copy=True)
    assert str(j.dtype) == dtype and (j.n_rows, j.n_live) == (t.n_rows, t.n_live)
    tflat._assert_same(_pallas(j), t, rng.standard_normal((6, 64)).astype(np.float32), 10)
    store.close()
    pub.close()


@pytest.mark.parametrize("rescore", ["bfloat16", "float32", None])
def test_int8_both_ways(tmp_path, rng, rescore):
    j = JInt8(64, rescore_dtype=rescore, rescore_k=50, tile_n=256)
    j.add(rng.standard_normal((300, 64)).astype(np.float32))
    j.delete(np.arange(0, 300, 7))
    q = rng.standard_normal((5, 64)).astype(np.float32)
    pub = jsnap.publish_index_shm(j, str(tmp_path / "j.shm"))
    t, store = tsnap.attach_index_shm(pub.segment.path, device=CPU)
    tint8._assert_same(j, t, q, 10)
    store.close()
    pub.close()
    # and back: the port's own index, attached by JAX
    t2 = Int8FlatIndex(64, rescore_dtype=rescore, rescore_k=50, tile_n=256, device=CPU)
    t2.add(rng.standard_normal((200, 64)).astype(np.float32))
    pub = tsnap.publish_index_shm(t2, str(tmp_path / "t.shm"))
    j2, store = jsnap.attach_index_shm(pub.segment.path, copy=True)
    tint8._assert_same(j2, t2, q, 10)
    store.close()
    pub.close()


def _assert_ivfpq_same(j, t, q, k=10):
    js, ji = j.search(q, k)
    ts, ti = t.search(q, k)
    if t.refine == "none":
        true = tivfpq._adc_judge(t, q)
    else:
        rows, scales = (t._raw_chunks[0], t._raw_scales[0]) if t._raw_chunks else \
            (a.numpy() for a in t._dev_bank())
        true = tivfpq._exact_judge(t, q, rows, scales)
    assert_topk_equiv(ts, ti, js, ji, None, None, None, true=true)


@pytest.mark.parametrize("refine,opq", [("int8", False), ("int8_device", False), ("f32", True),
                                        ("none", False)])
def test_ivfpq_published_by_jax_attached_by_port(tmp_path, refine, opq):
    x, _ = tivfpq._clustered(np.random.default_rng(11), 1200)
    j = tivfpq.JPQ(tivfpq.D, nlist=16, nprobe=6, m=8, kmeans_iters=4, pq_iters=4, refine=refine,
                   opq=opq, opq_iters=2)
    j.train(x)
    j.add(x)
    j.delete(np.arange(0, len(x), 29))
    pub = jsnap.publish_index_shm(j, str(tmp_path / "j.shm"))
    t, store = tsnap.attach_index_shm(pub.segment.path, copy=True, device=CPU)
    assert t.stats() == j.stats() and (t._rot is not None) == opq
    q = x[:7] + 0.05 * np.random.default_rng(2).standard_normal((7, tivfpq.D)).astype(np.float32)
    _assert_ivfpq_same(j, t, q)
    store.close()
    pub.close()


@pytest.mark.parametrize("refine", ["int8", "int8_device"])
def test_ivfpq_published_by_port_attached_by_jax(tmp_path, refine):
    t, x = _port_ivfpq(rows=400, dim=tivfpq.D, seed=3, refine=refine)
    t.delete(np.arange(0, 400, 23))
    pub = tsnap.publish_index_shm(t, str(tmp_path / "t.shm"))
    j, store = jsnap.attach_index_shm(pub.segment.path, copy=True)
    assert j.n_live == t.n_live and j.refine == refine
    _assert_ivfpq_same(j, t, x[:6] + 0.01)
    store.close()
    pub.close()


CHILD = r"""
import json, sys
import numpy as np
from codegraph_tpu_torch.search.service import ShmServedIndex

path, qpath = sys.argv[1], sys.argv[2]
served = ShmServedIndex(path, check_every=0.0, device="cpu")
for line in sys.stdin:
    q = np.load(qpath)
    reloaded = served.maybe_reload() if line.strip() == "poll" else False
    s, i = served.search(q, 3)
    print(json.dumps({"reloaded": reloaded, "n": len(served), "reloads": served.reloads,
                      "ids": i.tolist(), "scores": s.tolist()}), flush=True)
"""


def test_served_index_in_a_second_process_reloads(tmp_path):
    """The publisher (this process, the JAX package) republishes in place
    and then recreates the segment under a new inode; a CPU ShmServedIndex
    in a subprocess of the port reloads each time and answers like the
    publisher's index."""
    p, qp = str(tmp_path / "serve.shm"), str(tmp_path / "q.npy")
    env = dict(os.environ, PYTHONPATH=REPO)
    rng = np.random.default_rng(12)
    j = _pallas(JFlat(48))
    j.add(rng.standard_normal((120, 48)).astype(np.float32))
    pub = jsnap.publish_index_shm(j, p, slack=0.5)
    child = subprocess.Popen([sys.executable, "-c", CHILD, p, qp], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
                             cwd=REPO)

    def ask(cmd):
        q = rng.standard_normal((4, 48)).astype(np.float32)
        np.save(qp, q)
        child.stdin.write(cmd + "\n")
        child.stdin.flush()
        line = child.stdout.readline()
        assert line, child.stderr.read()
        got = json.loads(line)
        s, i = j.search(q, 3)
        np.testing.assert_array_equal(np.asarray(got["ids"]), i)
        np.testing.assert_allclose(np.asarray(got["scores"]), s, rtol=0, atol=1e-5)
        return got

    try:
        first = ask("search")
        assert first["n"] == 120 and first["reloads"] == 1
        j.delete(np.arange(0, 120, 5))
        j.add(rng.standard_normal((10, 48)).astype(np.float32))
        pub.close()
        pub = jsnap.publish_index_shm(j, p)  # in place: the generation moves
        got = ask("poll")
        assert got["reloaded"] and got["n"] == j.n_live and got["reloads"] == 2
        assert not ask("poll")["reloaded"]
        pub.close()
        os.unlink(p)
        j = _pallas(JFlat(48))
        j.add(rng.standard_normal((70, 48)).astype(np.float32))
        pub = jsnap.publish_index_shm(j, p)  # a new file: a new inode
        got = ask("poll")
        assert got["reloaded"] and got["n"] == 70 and got["reloads"] == 3
    finally:
        child.stdin.close()
        assert child.wait(timeout=60) == 0, child.stderr.read()
        pub.close()

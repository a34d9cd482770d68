"""Copy of `codegraph_tpu/index/snapshot.py` for the PyTorch port, with
its shared-memory half: `publish_index_shm` writes the same arrays and meta
as the JAX package's (so either package attaches the other's segment), and
`attach_index_shm` adopts them through each index's `load_arrays` on the
device it is given ("cuda" unless the caller asks for the CPU). A segment
of another kind than flat, int8 or ivfpq raises SnapshotError (the JAX
package attaches it as a flat index).

Zero-copy index snapshots: mmap-backed array persistence + manifest.

Reference: the native persistence layer — codegraph-zerocopy/src/mmap.rs
(mmap'd rkyv archives), codegraph-vector/src/memory.rs:242-415 (mmap
save/load of f32 matrices), persistent.rs:480-710 (header + metadata +
backups). Re-design: every array persists as a raw .npy (np.lib.format)
which loads back as a read-only memory map — the OS pages bytes in on
demand, so host startup cost is O(1) and the upload to the device streams
straight from the page cache. A JSON manifest carries shapes/dtypes/meta
plus a BLAKE2 content digest for integrity, and writes go through a
temp-file rename so a crashed save never corrupts the previous snapshot
(the reference's backup discipline).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from codegraph_tpu_torch.core.errors import SnapshotError

MANIFEST = "index_manifest.json"


def _digest(path: str, max_bytes: int = 1 << 20) -> str:
    """Digest of header + first/last 1MB — integrity canary without
    re-reading multi-GB matrices."""
    h = hashlib.blake2b(digest_size=16)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        h.update(f.read(max_bytes))
        if size > 2 * max_bytes:
            f.seek(-max_bytes, os.SEEK_END)
            h.update(f.read(max_bytes))
    h.update(str(size).encode())
    return h.hexdigest()


def save_arrays(
    directory: str,
    arrays: Dict[str, np.ndarray],
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Atomically persist named arrays + metadata. Returns manifest path."""
    os.makedirs(directory, exist_ok=True)
    entries = {}
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        final = os.path.join(directory, f"{name}.npy")
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, arr)  # via handle: np.save(path) appends .npy
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        entries[name] = {
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "digest": _digest(final),
        }
    manifest = {"arrays": entries, "meta": meta or {}}
    mpath = os.path.join(directory, MANIFEST)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, mpath)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return mpath


def load_arrays(
    directory: str, mmap: bool = True, verify: bool = True
) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Load arrays (read-only memory maps by default) + metadata."""
    mpath = os.path.join(directory, MANIFEST)
    if not os.path.exists(mpath):
        raise SnapshotError(f"no index manifest at {directory}")
    with open(mpath) as f:
        manifest = json.load(f)
    out: Dict[str, np.ndarray] = {}
    for name, entry in manifest["arrays"].items():
        path = os.path.join(directory, f"{name}.npy")
        if not os.path.exists(path):
            raise SnapshotError(f"snapshot array missing: {name}")
        if verify and _digest(path) != entry["digest"]:
            raise SnapshotError(f"snapshot array corrupt: {name}")
        arr = np.load(path, mmap_mode="r" if mmap else None)
        if list(arr.shape) != entry["shape"] or str(arr.dtype) != entry["dtype"]:
            raise SnapshotError(
                f"snapshot array {name} shape/dtype mismatch with manifest"
            )
        out[name] = arr
    return out, manifest.get("meta", {})


def publish_index_shm(index, path: str, slack: float = 0.5):
    """Publish an index's state into a shared-memory segment
    (core/shm.py) so other processes on this host can serve it without
    their own copy — the cross-process serving path the reference builds
    on codegraph-zerocopy/src/shared_memory.rs. Supports all three
    serving tiers: FlatIndex (f32/bf16), Int8FlatIndex (+rescore
    matrix), and IVFPQIndex (codes/books/ids/bias + refine rows — the
    100M-row capacity tier). Device tensors are copied to the host once.
    Returns the open SharedArrayStore (close it to detach; the file
    persists).

    Republish-friendly: when the segment already exists and has
    capacity, the new payload goes through the seqlock publish on the
    SAME segment — the generation stays monotonic, which is what
    hot-reload readers (search/service.py ShmServedIndex) watch.
    A fresh segment is created with `slack` growth headroom so routine
    incremental growth republishes in place."""
    from codegraph_tpu_torch.core.shm import ShmError, SharedArrayStore
    from codegraph_tpu_torch.index.flat import FlatIndex
    from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex
    from codegraph_tpu_torch.index.ivfpq import IVFPQIndex

    if isinstance(index, IVFPQIndex):
        if index._x is None or index._books is None:
            raise SnapshotError("cannot publish an untrained/empty index")
        meta = {
            "kind": "ivfpq", "dim": index.dim, "metric": index.metric,
            "nlist": index.nlist, "nprobe": index.nprobe,
            "m": index.m, "nbits": index.nbits,
            "list_cap": index.list_cap,
            "refine": index.refine, "refine_factor": index.refine_factor,
            "code_layout": "subspace_major",
            "n_rows": index.n_rows, "n_live": index.n_live,
        }
        arrays = {
            "centroids": index._centroids.float(),
            "code_lists": index._x,                      # uint8
            "id_lists": index._ids.int(),
            "bias_lists": index._bias.float(),
            "books": index._books.float(),
            "fill": np.asarray(index._fill, np.int64),
        }
        if index._rot is not None:
            # OPQ pre-rotation: attachers must rotate queries the same way
            arrays["opq_rot"] = index._rot.float()
        if index._raw_chunks:
            arrays["refine_rows"] = np.concatenate(index._raw_chunks)
            arrays["refine_scales"] = np.concatenate(index._raw_scales)
        elif index._dev_chunks:
            # int8_device: the bank lives on the device; the segment holds
            # a host copy (attachers upload it again). Preallocation
            # padding is sliced off so the segment is exactly n_rows.
            bank, scales = index._dev_bank()
            arrays["refine_rows"] = bank[: index.n_rows]
            arrays["refine_scales"] = scales[: index.n_rows]
    elif isinstance(index, Int8FlatIndex):
        q, s, r, bias = index.arrays()
        if q is None:
            raise SnapshotError("cannot publish an empty index")
        meta = {
            "kind": "int8", "dim": index.dim, "metric": index.metric,
            "rescore_dtype": (str(index.rescore_dtype).replace("torch.", "")
                              if index.rescore_dtype else None),
            "rescore_k": index.rescore_k, "tile_n": index.tile_n,
            "n_rows": index.n_rows, "n_live": index.n_live,
        }
        arrays = {"q": q, "s": s, "bias": bias}
        if r is not None:
            arrays["r"] = r
    elif isinstance(index, FlatIndex):
        x, bias = index.arrays()
        if x is None:
            raise SnapshotError("cannot publish an empty index")
        meta = {
            "kind": "flat", "dim": index.dim, "metric": index.metric,
            "dtype": index.dtype_name, "tile_n": index.tile_n,
            "n_rows": index.n_rows, "n_live": index.n_live,
        }
        arrays = {"x": x, "bias": bias}
    else:
        raise SnapshotError(
            f"shm serving supports the flat/int8 exact tiers and IVF-PQ, not "
            f"{type(index).__name__} (use the directory snapshot for IVF)"
        )
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    if os.path.exists(path):
        try:
            store = SharedArrayStore.open(path, writable=True)
            try:
                store.publish(arrays)
                return store
            except ShmError:    # outgrew capacity: recreate
                store.close()
        except ShmError:
            pass                # corrupt/foreign file: recreate
    return SharedArrayStore.create(path, arrays, slack=slack)


def attach_index_shm(path: str, copy: bool = False, device="cuda"):
    """Attach to a published index segment. Returns (index, store);
    the index type comes from the segment's metadata, and its arrays go
    to `device` (asking for CUDA without a GPU raises before the segment
    is opened).

    copy=False: the arrays are read from views of the shared pages (a CPU
    index gets its own copy of each); keep `store` open while the index
    loads and do not republish under it. copy=True: a stable seqlock-read
    snapshot — safe against concurrent republishes (what hot-reload
    servers use). Attached copies are read-only serving replicas: an
    IVF-PQ index gets no row -> (cell, pos) delete map (deletes belong to
    the publisher, which republishes with a fresh generation)."""
    from codegraph_tpu_torch.core.shm import SharedArrayStore
    from codegraph_tpu_torch.index.flat import FlatIndex, resolve_device
    from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex
    from codegraph_tpu_torch.index.ivfpq import IVFPQIndex

    dev = resolve_device(device)
    store = SharedArrayStore.open(path)
    arrs = store.arrays(copy=copy)
    if not copy and dev.type == "cpu":
        # bf16 entries are tensors over the shared (read-only) pages
        arrs = {k: v.clone() if torch.is_tensor(v) else v for k, v in arrs.items()}
    meta = json.loads(bytes(arrs["_meta"]).decode())
    kind = meta.get("kind", "flat")
    if kind == "ivfpq":
        idx = IVFPQIndex(
            meta["dim"], nlist=meta["nlist"], nprobe=meta["nprobe"],
            m=meta["m"], nbits=meta["nbits"], metric=meta["metric"],
            refine=meta["refine"], refine_factor=meta["refine_factor"],
            device=dev,
        )
        # load_arrays makes K8's extents again from the fills
        idx.load_arrays(arrs["centroids"], arrs["code_lists"], arrs["id_lists"],
                        arrs["bias_lists"], arrs["fill"], int(meta["list_cap"]),
                        int(meta["n_rows"]), int(meta["n_live"]), books=arrs["books"],
                        rot=arrs.get("opq_rot"), refine_rows=arrs.get("refine_rows"),
                        refine_scales=arrs.get("refine_scales"))
        idx._row_loc = np.full((0, 2), -1, np.int64)  # a delete raises KeyError
    elif kind == "int8":
        idx = Int8FlatIndex(meta["dim"], metric=meta["metric"],
                            rescore_dtype=meta["rescore_dtype"],
                            rescore_k=meta["rescore_k"],
                            tile_n=meta["tile_n"], device=dev)
        idx.load_arrays(arrs["q"], arrs["s"], arrs.get("r"),
                        arrs["bias"], meta["n_rows"], meta["n_live"])
    elif kind == "flat":
        idx = FlatIndex(meta["dim"], metric=meta["metric"],
                        dtype=meta["dtype"], tile_n=meta["tile_n"], device=dev)
        idx.load_arrays(arrs["x"], arrs["bias"], meta["n_rows"],
                        meta["n_live"])
    else:
        store.close()
        raise SnapshotError(f"{path}: no shm attach for an index of kind {kind!r}")
    return idx, store


# original flat-only names, kept as aliases
publish_flat_shm = publish_index_shm
attach_flat_shm = attach_index_shm


__all__ = [
    "save_arrays",
    "load_arrays",
    "publish_index_shm",
    "attach_index_shm",
    "publish_flat_shm",
    "attach_flat_shm",
    "MANIFEST",
]

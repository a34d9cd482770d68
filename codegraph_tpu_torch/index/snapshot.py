"""Copy of `codegraph_tpu/index/snapshot.py` for the PyTorch port (the
shared-memory publish/attach half is not ported yet).

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


__all__ = [
    "save_arrays",
    "load_arrays",
    "MANIFEST",
]

"""Copy of `codegraph_tpu/core/shm.py` for the PyTorch port. Segments are
byte-compatible with the JAX package's (the same header, seqlock and
`_pack_arrays` layout), so either package attaches the other's. A bf16
entry is still named "bfloat16" in the manifest, but the port reads and
writes its 2-byte values itself: numpy knows that name only once
`ml_dtypes` is imported, which the port does not need. A torch.bfloat16
tensor is written through an int16 view of its bits, and a "bfloat16"
entry reads back as a torch.bfloat16 tensor (a view of the same bytes);
an `ml_dtypes` bfloat16 array, which the JAX package writes, is written
as it is.

Cross-process shared-memory segments for zero-copy index serving.

Re-implements crates/codegraph-zerocopy/src/shared_memory.rs (633 LoC:
SharedMemorySegment create/open at :52/:100, generation-seqlock
reader/writer at :140-342, SharedMemoryManager get_or_create/remove/
list/cleanup at :362-478) the same way the reference does — file-backed
mmap under a base directory, so any process that knows the path can
attach without copying — with a numpy layer on top: a segment publishes
a set of named arrays (the corpus of an index snapshot, id maps, PQ
codebooks) and readers get zero-copy `np.frombuffer` views backed by
shared pages. The daemon (daemon.py) and MCP server processes can serve
one resident copy of an index this way; feeding the device from a shared
segment costs no extra host RAM per process.

Concurrency follows the reference's seqlock: the writer bumps the
header generation to ODD before mutating and back to EVEN after, and
readers retry while the generation is odd or changed mid-read
(shared_memory.rs:152-189 does the same with atomics; Python's mmap
writes of an 8-byte aligned field are atomic enough for this protocol
on CPython because the GIL serializes the slice assignment).
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

_MAGIC = 0x434753484D454D31  # "CGSHMEM1"
_HEADER = struct.Struct("<QQQQ")  # magic, generation, payload_len, capacity
# payload starts at a 64-byte boundary so in-payload alignment (_ALIGN)
# holds relative to the page-aligned mmap base
HEADER_SIZE = 64
assert _HEADER.size <= HEADER_SIZE


class ShmError(RuntimeError):
    pass


@dataclass
class SegmentStats:
    name: str
    capacity: int
    payload_len: int
    generation: int


class SharedSegment:
    """One file-backed mmap segment with a seqlock'd byte payload.

    create() truncates/initializes; open() attaches to an existing
    segment (shared_memory.rs:52-138). Writers and readers may live in
    different processes; the kernel page cache is the shared medium.
    """

    def __init__(self, path: str, mm: mmap.mmap, fileno: int,
                 writable: bool):
        self.path = path
        self._mm = mm
        self._fd = fileno
        self._writable = writable

    # -- lifecycle ----------------------------------------------------

    @classmethod
    def create(cls, path: str, capacity: int) -> "SharedSegment":
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        total = HEADER_SIZE + capacity
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            # never SHRINK an existing file: readers holding mmaps of a
            # larger previous generation would SIGBUS past the new end
            old_size = os.fstat(fd).st_size
            total = max(total, old_size)
            capacity = total - HEADER_SIZE
            # recreating IN PLACE (capacity growth on the same path):
            # carry the old generation forward, else hot-reload readers
            # comparing (inode, generation) would see the same pair after
            # the first publish and keep serving the stale snapshot
            gen = 0
            if old_size >= _HEADER.size:
                try:
                    buf = os.pread(fd, _HEADER.size, 0)
                    magic, old_gen, _, _ = _HEADER.unpack(buf)
                    if magic == _MAGIC:
                        gen = old_gen
                except OSError:
                    pass
            os.ftruncate(fd, total)
            mm = mmap.mmap(fd, total)
        except Exception:
            os.close(fd)
            raise
        # mark odd (write in progress) until the first write() publishes;
        # attached readers spin rather than observe a torn reset
        mm[:_HEADER.size] = _HEADER.pack(_MAGIC, gen | 1, 0, capacity)
        return cls(path, mm, fd, writable=True)

    @classmethod
    def open(cls, path: str, writable: bool = False) -> "SharedSegment":
        if not os.path.exists(path):
            raise ShmError(f"no shared segment at {path}")
        fd = os.open(path, os.O_RDWR if writable else os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            mm = mmap.mmap(fd, size,
                           prot=(mmap.PROT_READ | mmap.PROT_WRITE)
                           if writable else mmap.PROT_READ)
        except Exception:
            os.close(fd)
            raise
        magic, _, _, cap = _HEADER.unpack(mm[:_HEADER.size])
        if magic != _MAGIC:
            mm.close()
            os.close(fd)
            raise ShmError(f"{path}: bad magic {magic:#x}")
        if HEADER_SIZE + cap > size:
            mm.close()
            os.close(fd)
            raise ShmError(f"{path}: truncated segment")
        return cls(path, mm, fd, writable=writable)

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                # zero-copy views (SharedArrayStore.arrays(copy=False))
                # still reference the pages; drop our handle and let the
                # mapping unmap when the last view is garbage-collected
                pass
            self._mm = None
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- header -------------------------------------------------------

    def _read_header(self):
        return _HEADER.unpack(self._mm[:_HEADER.size])

    @property
    def capacity(self) -> int:
        return self._read_header()[3]

    @property
    def generation(self) -> int:
        return self._read_header()[1]

    def is_updated_since(self, generation: int) -> bool:
        return self.generation != generation

    def stats(self) -> SegmentStats:
        _, gen, plen, cap = self._read_header()
        return SegmentStats(name=os.path.basename(self.path),
                            capacity=cap, payload_len=plen, generation=gen)

    # -- seqlock write/read -------------------------------------------

    def write(self, data: bytes) -> None:
        """Publish a new payload (shared_memory.rs:295-332): generation
        goes odd -> payload + length -> even, so readers never observe a
        torn payload as current."""
        if not self._writable:
            raise ShmError("segment opened read-only")
        magic, gen, _, cap = self._read_header()
        if len(data) > cap:
            raise ShmError(f"payload {len(data)} > capacity {cap}")
        # `gen | 1` handles both a normal even start and the odd
        # "in-progress" generation a fresh create() leaves behind
        g_odd = gen | 1
        self._mm[:_HEADER.size] = _HEADER.pack(magic, g_odd, len(data), cap)
        self._mm[HEADER_SIZE:HEADER_SIZE + len(data)] = data
        self._mm[:_HEADER.size] = _HEADER.pack(magic, g_odd + 1, len(data), cap)
        self._mm.flush(0, HEADER_SIZE)

    def read(self, max_retries: int = 1000) -> bytes:
        """Seqlock read: retry while a writer is mid-publish."""
        for _ in range(max_retries):
            magic, g1, plen, cap = self._read_header()
            if g1 % 2 == 1:
                time.sleep(0.0005)
                continue
            data = bytes(self._mm[HEADER_SIZE:HEADER_SIZE + plen])
            g2 = self._read_header()[1]
            if g1 == g2:
                return data
        raise ShmError("read contended beyond retry budget")

    def view(self) -> memoryview:
        """Zero-copy view of the current payload. The caller must
        tolerate concurrent republishes (check generation around use) or
        coordinate with the writer."""
        plen = self._read_header()[2]
        return memoryview(self._mm)[HEADER_SIZE:HEADER_SIZE + plen]


# -- named-array layer (the index-serving payload format) --------------

_ALIGN = 64  # cache-line align each array for vectorized readers


def _host_array(arr):
    """(contiguous numpy array, manifest dtype name) of a numpy array or a
    tensor; a torch.bfloat16 tensor goes as the int16 view of its bits."""
    if torch.is_tensor(arr):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    # dtype by NAME: ml_dtypes types (bfloat16) have an opaque
    # dtype.str ('<V2') but round-trip through np.dtype(name)
    return arr, arr.dtype.name


def _pack_arrays(arrays: Dict[str, object]) -> bytes:
    entries = []
    blobs = []
    off = 0
    for name, arr in arrays.items():
        arr, dtype_name = _host_array(arr)
        pad = (-off) % _ALIGN
        off += pad
        entries.append({"name": name, "dtype": dtype_name,
                        "shape": list(arr.shape), "offset": off,
                        "nbytes": arr.nbytes})
        blobs.append((pad, arr.tobytes()))
        off += arr.nbytes
    manifest = json.dumps(entries).encode()
    head = struct.pack("<Q", len(manifest)) + manifest
    base_pad = (-len(head)) % _ALIGN
    out = [head, b"\0" * base_pad]
    for pad, blob in blobs:
        out.append(b"\0" * pad)
        out.append(blob)
    return b"".join(out)


def _unpack_arrays(buf, copy: bool) -> Dict[str, object]:
    """Named arrays of a payload: numpy arrays, and torch.bfloat16 tensors
    for the "bfloat16" entries (read through uint16, so no `ml_dtypes`)."""
    (mlen,) = struct.unpack_from("<Q", buf, 0)
    manifest = json.loads(bytes(buf[8:8 + mlen]).decode())
    base = 8 + mlen
    base += (-base) % _ALIGN
    out = {}
    for e in manifest:
        start = base + e["offset"]
        bf16 = e["dtype"] == "bfloat16"
        a = np.frombuffer(buf, dtype=np.uint16 if bf16 else np.dtype(e["dtype"]),
                          count=int(np.prod(e["shape"], dtype=np.int64))
                          if e["shape"] else 1,
                          offset=start).reshape(e["shape"])
        if copy:
            a = a.copy()
        if bf16:
            if not a.flags.writeable:
                # torch has no read-only tensors: the view is shared pages
                # that the caller must not write (see arrays(copy=False))
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    a = torch.from_numpy(a)
            else:
                a = torch.from_numpy(a)
            a = a.view(torch.bfloat16)
        out[e["name"]] = a
    return out


class SharedArrayStore:
    """Named arrays in a shared segment (numpy arrays; torch.bfloat16
    tensors for bf16 entries) — the serving-side payload
    (an index snapshot's corpus/ids/codebooks) published once and mapped
    by every reader process."""

    def __init__(self, segment: SharedSegment):
        self.segment = segment

    @classmethod
    def create(cls, path: str, arrays: Dict[str, object],
               slack: float = 0.0) -> "SharedArrayStore":
        payload = _pack_arrays(arrays)
        cap = len(payload) + int(len(payload) * slack) + _ALIGN
        seg = SharedSegment.create(path, cap)
        seg.write(payload)
        return cls(seg)

    @classmethod
    def open(cls, path: str, writable: bool = False) -> "SharedArrayStore":
        return cls(SharedSegment.open(path, writable=writable))

    def publish(self, arrays: Dict[str, object]) -> None:
        self.segment.write(_pack_arrays(arrays))

    def arrays(self, copy: bool = False) -> Dict[str, object]:
        """copy=False: zero-copy views over the shared pages (valid
        while the store is open and the writer does not republish);
        copy=True: a stable snapshot via the seqlock read path."""
        if copy:
            return _unpack_arrays(self.segment.read(), copy=True)
        return _unpack_arrays(self.segment.view(), copy=False)

    @property
    def generation(self) -> int:
        return self.segment.generation

    def close(self) -> None:
        self.segment.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SharedMemoryManager:
    """Segments under one base directory (shared_memory.rs:362-478):
    get_or_create / open / remove / list / stats / cleanup_unused."""

    def __init__(self, base_path: str):
        self.base = os.path.abspath(base_path)
        os.makedirs(self.base, exist_ok=True)

    def _path(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise ShmError(f"invalid segment name {name!r}")
        return os.path.join(self.base, name + ".shm")

    def get_or_create(self, name: str, capacity: int) -> SharedSegment:
        path = self._path(name)
        if os.path.exists(path):
            seg = SharedSegment.open(path, writable=True)
            if seg.capacity >= capacity:
                return seg
            # grow in place: create() ftruncates up and carries the
            # generation forward (never shrinks), so existing readers
            # stay valid and hot-reload watchers see a monotonic bump
            seg.close()
            return SharedSegment.create(path, capacity)
        return SharedSegment.create(path, capacity)

    def open(self, name: str, writable: bool = False) -> SharedSegment:
        return SharedSegment.open(self._path(name), writable=writable)

    def remove(self, name: str) -> None:
        path = self._path(name)
        if os.path.exists(path):
            os.unlink(path)

    def list_segments(self) -> List[str]:
        return sorted(
            f[:-4] for f in os.listdir(self.base) if f.endswith(".shm")
        )

    def all_stats(self) -> List[SegmentStats]:
        out = []
        for name in self.list_segments():
            try:
                with self.open(name) as seg:
                    out.append(seg.stats())
            except ShmError:
                continue
        return out

    def cleanup_unused(self, max_age_s: float = 86400.0) -> int:
        """Remove segments whose backing file has not been republished
        within max_age_s (the reference prunes by refcount at :449;
        cross-process refcounts need a daemon, so age stands in)."""
        now = time.time()
        n = 0
        for name in self.list_segments():
            p = self._path(name)
            try:
                if now - os.path.getmtime(p) > max_age_s:
                    os.unlink(p)
                    n += 1
            except OSError:
                continue
        return n


__all__ = [
    "ShmError",
    "SharedSegment",
    "SharedArrayStore",
    "SharedMemoryManager",
    "SegmentStats",
    "HEADER_SIZE",
]

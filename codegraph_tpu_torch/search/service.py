"""Copy of `codegraph_tpu/search/service.py` for the PyTorch port;
`close()` joins the collector thread and shuts the flush pool,
`ShmServedIndex` uploads each snapshot to the device it is given, and the
service records its steps as spans (`utils/perfmon.py`; PERF.md §3):
`service.linger` (the max_wait sleep), `service.collect` (wake to batch
taken; n rows, m their summed queue wait in µs), `service.flush` (batch
taken to last future set; n rows searched, m zero rows padded; opened on
the collector, closed on the flush worker) and inside it
`service.assemble` and `service.fanout`, all under one request id per
flush. Submit stamps are on the recorder's clock (`perf_counter_ns`).

Batching query service: concurrent queries -> device-sized batches.

The serving-path answer to the reference's concurrent-throughput target
(1k -> 2k QPS, performance_monitor.rs:68) and to dispatch overhead:
individual queries queue up and a collector thread flushes them to the
index as one [B, D] batch (flush on max_batch or max_wait). Per-query
dispatch overhead (tens of ms through a remote transport; ~10us locally)
amortizes across the whole batch — the same reason the index kernels
take query *batches* everywhere. Callers get concurrent futures.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from codegraph_tpu_torch.utils import perfmon


@dataclass
class ServiceStats:
    queries: int = 0
    batches: int = 0
    max_batch_seen: int = 0
    shed: int = 0      # rejected at admission (queue full)
    expired: int = 0   # dropped at flush (exceeded queue deadline)

    @property
    def avg_batch(self) -> float:
        return self.queries / self.batches if self.batches else 0.0


class ServiceOverloaded(RuntimeError):
    """Admission control rejected the query: the pending queue is at
    max_pending. The HTTP layer maps this to 429; callers should back
    off. Bounding the queue bounds worst-case latency to roughly
    max_pending / capacity instead of letting p99 grow without limit
    (reference target: bounded latency at 1k->2k QPS sustained,
    performance_monitor.rs:68)."""


class QueryService:
    """Wraps any index with search(queries [B, D], k) in a batch collector."""

    #: per-tier batching policies, from the measured round-3/4 serving
    #: sweeps (BENCH_SWEEP_TPU_r3.json serving_latency + *_tuned): a
    #: corpus-bound full scan (flat/int8) pays the same HBM read per
    #: flush regardless of batch size, so capacity = max_batch /
    #: flush_time — big batches win and small ones collapse under load
    #: (tuned max_batch=64 drove int8 rate-3000 p50 from 1.6 s to 5 s).
    #: IVF-PQ's flush cost is smaller and less batch-sensitive, so small
    #: batches + more in-flight workers win latency there (rate-3000
    #: p50 3248 -> 270 ms in the same sweep).
    POLICIES = {
        "scan": dict(max_batch=1024, max_wait_ms=2.0, workers=4,
                     pad_buckets=(64, 256, 1024)),
        "ivf": dict(max_batch=64, max_wait_ms=2.0, workers=8,
                    pad_buckets=(16, 64)),
    }

    @classmethod
    def policy_for(cls, index) -> dict:
        """Pick the batching policy from the index tier, so operators
        don't have to transcribe bench notes into flags. ShmServedIndex
        and sharded wrappers (JAX package) are unwrapped to the
        underlying tier."""
        inner = index
        for attr in ("_idx", "index", "base"):
            nxt = getattr(inner, attr, None)
            if nxt is not None and nxt is not inner:
                inner = nxt
        name = type(inner).__name__.lower()
        if "ivf" in name:
            return dict(cls.POLICIES["ivf"])
        return dict(cls.POLICIES["scan"])

    @classmethod
    def auto(cls, index, k: int = 10, **overrides) -> "QueryService":
        """QueryService with the measured per-tier default policy."""
        kw = cls.policy_for(index)
        kw.update(overrides)
        return cls(index, k=k, **kw)

    def __init__(
        self,
        index,
        k: int = 10,
        max_batch: int = 64,
        max_wait_ms: float = 2.0,
        pad_to_max: bool = True,
        workers: int = 1,
        max_pending: Optional[int] = None,
        queue_timeout_ms: Optional[float] = None,
        pad_buckets: Optional[Tuple[int, ...]] = None,
    ):
        """pad_to_max: zero-pad every flushed batch to max_batch rows so
        the jitted index kernels compile for exactly ONE batch shape.
        Without it, every distinct batch size triggers a fresh XLA
        compile (tens of seconds each) and the service builds a
        standing queue under load — measured as multi-second p50 at
        light arrival rates. The scan cost is corpus-dominated, so the
        padded rows are nearly free.

        pad_buckets: optional ascending batch-shape buckets (each a
        compiled kernel shape); a flush pads to the SMALLEST bucket that
        fits instead of always to max_batch. Always padding to a big
        max_batch makes every light-load flush carry the full padded
        query upload — measured on the round-4 auto sweep as p50
        492 ms at 200 arrivals/s (3.1 MB of 97% padding per flush over
        the dev transport) vs ~120 ms with a 256-shape. Buckets keep
        light load on small cheap shapes while overload still rides
        full max_batch flushes; only len(pad_buckets) shapes ever
        compile. The last bucket must equal max_batch.

        workers: number of concurrent flush workers. With 1 (default)
        the collector flushes inline, so each batch pays the full
        dispatch + device + host-fetch latency before the next batch
        can start. With R > 1, batches are handed to R flush threads,
        keeping up to R index calls in flight — the serving-loop
        analogue of the pipelined kernel protocol (bench.py): fixed
        per-call transport overhead overlaps with device compute
        instead of serializing behind it. A semaphore bounds in-flight
        flushes at R, so overload back-pressures into larger batches
        rather than an unbounded dispatch queue.

        max_pending: admission bound — submits beyond this many queued
        queries raise ServiceOverloaded (shed, counted in stats.shed).
        Default = 8 * max_batch * workers, roughly 8 full rounds of
        capacity, which caps queueing delay at ~8 flush times.

        queue_timeout_ms: optional per-query deadline — queries older
        than this at flush time fail with TimeoutError instead of
        occupying batch rows their caller has long stopped waiting for.
        """
        self.index = index
        self.k = int(k)
        self.max_batch = int(max_batch)
        self.max_wait_s = max_wait_ms / 1000.0
        self.pad_to_max = bool(pad_to_max)
        if pad_buckets:
            bks = sorted(int(b) for b in pad_buckets)
            if bks[-1] != self.max_batch:
                raise ValueError(
                    f"pad_buckets last entry {bks[-1]} != "
                    f"max_batch {self.max_batch}")
            self.pad_buckets: Tuple[int, ...] = tuple(bks)
        else:
            self.pad_buckets = (self.max_batch,)
        self.workers = max(1, int(workers))
        self.max_pending = (int(max_pending) if max_pending is not None
                            else 8 * self.max_batch * self.workers)
        self.queue_timeout_ns = (int(queue_timeout_ms * 1e6)
                                 if queue_timeout_ms else None)
        self.stats = ServiceStats()
        self._lock = threading.Lock()
        self._pending: List[Tuple[np.ndarray, Future, int]] = []
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._pool = (
            ThreadPoolExecutor(max_workers=self.workers,
                               thread_name_prefix="qsvc-flush")
            if self.workers > 1 else None
        )
        self._inflight = threading.Semaphore(self.workers)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, query: np.ndarray) -> Future:
        """Enqueue one query vector; resolves to (scores [k], rows [k]).
        Raises ServiceOverloaded when the pending queue is full."""
        fut: Future = Future()
        with self._lock:
            if len(self._pending) >= self.max_pending:
                self.stats.shed += 1
                raise ServiceOverloaded(
                    f"pending queue full ({self.max_pending}); retry later")
            self._pending.append(
                (np.asarray(query, np.float32), fut, time.perf_counter_ns()))
        # always wake: the collector blocks indefinitely while idle and
        # only uses the max_wait timeout between first enqueue and flush
        self._wake.set()
        return fut

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def warm(self, dim: int) -> None:
        """Compile every pad-bucket batch shape with one zero-query
        search per bucket (directly against the index, bypassing the
        queue). Call before serving traffic: an uncompiled shape hit
        mid-load stalls its whole flush for the XLA compile."""
        for b in self.pad_buckets:
            self.index.search(np.zeros((b, dim), np.float32), self.k)

    def search(self, query: np.ndarray, timeout: Optional[float] = 30.0):
        """Synchronous convenience wrapper."""
        return self.submit(query).result(timeout=timeout)

    def _loop(self) -> None:
        while not self._stop.is_set():
            # idle: block until a submit (or close) wakes us — a timed
            # wait here would spin ~1/max_wait times per second forever
            self._wake.wait()
            if self._stop.is_set():
                break
            rid = perfmon.new_request()
            # collect: give stragglers max_wait to join the batch unless
            # it is already full
            with self._lock:
                n = len(self._pending)
            if 0 < n < self.max_batch:
                with perfmon.span("service.linger", n=n, rid=rid):
                    time.sleep(self.max_wait_s)
            self._wake.clear()
            if self._pool is not None:
                # acquire the in-flight slot BEFORE slicing the batch:
                # while every worker is busy, new arrivals keep joining
                # the queue, so the batch taken when a slot frees is as
                # full as possible. Slicing first (as round 3 did) froze
                # half-full batches during the semaphore wait — measured
                # as avg_batch 117 of max 256 at overload, i.e. half the
                # capacity thrown away (padded rows cost the same HBM
                # scan as real ones).
                self._inflight.acquire()
                batch, flush = self._take_batch(rid)
                if not batch:
                    self._inflight.release()
                    continue
                self._pool.submit(self._flush_release, batch, flush)
            else:
                batch, flush = self._take_batch(rid)
                if batch:
                    self._flush(batch, flush)

    def _take_batch(self, rid: int):
        """The next batch, and its `service.flush` span, opened here."""
        with perfmon.span("service.collect", rid=rid) as collect:
            with self._lock:
                batch = self._pending[: self.max_batch]
                self._pending = self._pending[self.max_batch:]
                if self._pending:  # leftovers: keep the loop hot
                    self._wake.set()
            if collect is not perfmon.OFF:
                taken = time.perf_counter_ns()
                collect.n = len(batch)
                collect.m = (taken * len(batch) - sum(t for _, _, t in batch)) // 1000
        return batch, (perfmon.begin("service.flush", rid=rid) if batch else perfmon.OFF)

    def _flush_release(self, batch: List[Tuple[np.ndarray, Future, int]], flush) -> None:
        try:
            self._flush(batch, flush)
        finally:
            self._inflight.release()

    def _flush(self, batch: List[Tuple[np.ndarray, Future, int]], flush) -> None:
        """Search `batch` and resolve its futures; ends `flush`."""
        try:
            with perfmon.current(flush):
                self._search_batch(batch, flush)
        finally:
            perfmon.end(flush)

    def _search_batch(self, batch, flush) -> None:
        with perfmon.span("service.assemble"):
            if self.queue_timeout_ns is not None:
                now = time.perf_counter_ns()
                live = []
                for q, fut, t in batch:
                    if now - t > self.queue_timeout_ns:
                        with self._lock:
                            self.stats.expired += 1
                        if not fut.cancelled():
                            fut.set_exception(TimeoutError(
                                f"query queued > {self.queue_timeout_ns / 1e9:.3f}s"))
                    else:
                        live.append((q, fut, t))
                batch = live
                if not batch:
                    return
            queries = np.stack([q for q, _, _ in batch])
            if self.pad_to_max:
                shape = next(b for b in self.pad_buckets
                             if b >= queries.shape[0])
                if queries.shape[0] < shape:
                    queries = np.concatenate([
                        queries,
                        np.zeros((shape - queries.shape[0],
                                  queries.shape[1]), queries.dtype),
                    ])
            flush.n, flush.m = len(batch), queries.shape[0] - len(batch)
        try:
            scores, rows = self.index.search(queries, self.k)
        except Exception as exc:
            for _, fut, _ in batch:
                if not fut.cancelled():
                    fut.set_exception(exc)
            return
        with self._lock:
            self.stats.queries += len(batch)
            self.stats.batches += 1
            self.stats.max_batch_seen = max(self.stats.max_batch_seen,
                                            len(batch))
        with perfmon.span("service.fanout", n=len(batch)):
            for i, (_, fut, _) in enumerate(batch):
                if not fut.cancelled():
                    fut.set_result((scores[i], rows[i]))

    def close(self, timeout: float = 30.0) -> None:
        """Stop the collector, flush what is still queued, and shut the
        flush pool. Raises if the collector does not stop in `timeout`."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            raise RuntimeError(f"QueryService collector still running after {timeout}s")
        with self._lock:
            leftover = self._pending
            self._pending = []
        if leftover:
            self._flush(leftover, perfmon.begin("service.flush"))
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class ShmServedIndex:
    """Hot-reloadable index over a shared-memory segment.

    The production serving loop: a daemon re-indexes and republishes
    the index into the segment (index/snapshot.py publish_index_shm,
    seqlock + monotonic generation); every server process wraps the
    segment in a ShmServedIndex, which polls the generation at most
    every `check_every` seconds and swaps in the new arrays before the
    next search. The reference gets the same freshness from re-querying
    SurrealDB on every call (surrealdb_storage.rs) — here a reload is one
    seqlock snapshot read + device upload, and searches between reloads
    touch nothing but device memory.

    Recreated segments (a republish that outgrew capacity makes a new
    file) are detected by inode change, so generation comparisons never
    cross file lifetimes. A failed reload (ShmError/OSError: the
    publisher is mid-recreate) keeps the current snapshot and retries at
    the next poll. During a reload the old and the new device copies are
    both held; the old one is dropped right after the swap. Thread-safe;
    compose with QueryService for batch collection. `device`: "cuda"
    (default) or "cpu"; CUDA without a GPU raises.
    """

    def __init__(self, path: str, check_every: float = 1.0, device="cuda"):
        from codegraph_tpu_torch.index.flat import resolve_device

        self.path = path
        self.check_every = float(check_every)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._idx = None
        self._store = None
        self._ident: Optional[Tuple[int, int]] = None  # (inode, generation)
        self._last_check = 0.0
        self.reloads = 0
        self._reload()

    def _identity(self) -> Optional[Tuple[int, int]]:
        try:
            st = os.stat(self.path)
        except OSError:
            return None
        if self._store is not None and self._ident is not None \
                and st.st_ino == self._ident[0]:
            return (st.st_ino, self._store.segment.generation)
        return (st.st_ino, -1)  # new file: force reload to learn gen

    def _reload(self) -> None:
        from codegraph_tpu_torch.index.snapshot import attach_index_shm

        idx, store = attach_index_shm(self.path, copy=True, device=self.device)
        old = self._store
        # the swap drops the old index: its device copy is freed with its
        # last reference (a search still running on it holds one)
        self._idx, self._store = idx, store
        self._ident = (os.stat(self.path).st_ino, store.segment.generation)
        self.reloads += 1
        if old is not None:
            old.close()

    def maybe_reload(self) -> bool:
        """Check the segment generation (rate-limited); reload on change.
        Returns True when a reload happened."""
        from codegraph_tpu_torch.core.shm import ShmError

        now = time.monotonic()
        with self._lock:
            if self._idx is not None and \
                    now - self._last_check < self.check_every:
                return False
            self._last_check = now
            ident = self._identity()
            if ident is not None and ident != self._ident:
                try:
                    self._reload()
                except (ShmError, OSError):
                    # mid-recreate (publisher rebuilding/unlinking the
                    # segment between our stat and attach): keep serving
                    # the current snapshot, retry next poll
                    return False
                return True
        return False

    def search(self, queries: np.ndarray, k: int = 10, **kw):
        self.maybe_reload()
        return self._idx.search(queries, k, **kw)

    @property
    def generation(self) -> int:
        return self._ident[1] if self._ident else -1

    def __len__(self) -> int:
        return len(self._idx) if self._idx is not None else 0

    def close(self) -> None:
        with self._lock:
            if self._store is not None:
                self._store.close()
                self._store = None


__all__ = ["QueryService", "ServiceOverloaded", "ServiceStats",
           "ShmServedIndex"]

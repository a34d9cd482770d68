"""The one traffic generator: closed-loop clients, as a mix's file says.

A mix (`traffic/<mix>.json`) gives `clients` and `via`:

* `"via": "index"` (one client): the client calls the tier's
  `search(q[None], k)` itself, as hybrid search does, and sends its next
  query when the answer is back;
* `"via": "service"`: the clients submit to a `QueryService` over the
  tier, built with the tier's own policy (`QueryService.policy_for`), and
  each completion, in its callback, submits that client's next query.

Client c sends the query set in the seed's order, starting at c. Each
query is timed on the client's clock, from its submission to its answer.
A query shed by the service or timed out counts as failed.

Every call into the tier goes through `TimedIndex`, which records the
rows passed and its host-clock span.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from portbench.trace import WINDOW_SPAN


class Answers:
    """Every answer of a run in preallocated arrays, grown a chunk at a time:
    query index, submission and answer time on the client's clock, and the
    k rows and scores (an answer of another shape is only counted, in
    `misshapen`). Slots are taken under a lock, so callbacks on several
    threads can record at once."""

    CHUNK = 1 << 15

    def __init__(self, k: int):
        self.k = k
        self.n = 0
        self.misshapen = 0
        self._chunks: List[tuple] = []
        self._joined = None
        self._lock = threading.Lock()

    def add(self, qi: int, t0: float, t1: float, scores, ids) -> None:
        shaped = np.shape(scores) == (self.k,) and np.shape(ids) == (self.k,)
        with self._lock:
            if not shaped:
                self.misshapen += 1
                return
            slot = self.n
            self.n += 1
            if slot == len(self._chunks) * self.CHUNK:
                self._chunks.append((np.empty(self.CHUNK, np.int32), np.empty((self.CHUNK, 2)),
                                     np.empty((self.CHUNK, self.k), np.float32),
                                     np.empty((self.CHUNK, self.k), np.int32)))
            c_qi, c_t, c_s, c_i = self._chunks[slot // self.CHUNK]
        j = slot % self.CHUNK
        c_qi[j] = qi
        c_t[j] = (t0, t1)
        c_s[j] = scores
        c_i[j] = ids

    def arrays(self):
        """(qi [n], times [n, 2], scores [n, k], ids [n, k]) of the answers
        recorded so far (joined once for each count)."""
        if self._joined is None or len(self._joined[0]) != self.n:
            if not self._chunks:
                self._joined = (np.empty(0, np.int32), np.empty((0, 2)),
                                np.empty((0, self.k), np.float32), np.empty((0, self.k), np.int32))
            else:
                self._joined = tuple(np.concatenate([c[f] for c in self._chunks])[: self.n]
                                     for f in range(4))
        return self._joined


@dataclass
class Outcome:
    t_start: float
    t_end: float
    answers: Answers
    attempted: int = 0
    failed: int = 0          # shed or timed out
    errors: List[str] = field(default_factory=list)  # anything else raised
    unanswered: int = 0      # never came
    service_stats: Optional[dict] = None  # the service's counters over the run

    def times(self) -> np.ndarray:
        """[n, 2] submission and answer times of every answer."""
        return self.answers.arrays()[1]

    def latencies_in_window(self) -> np.ndarray:
        """Seconds from submission to answer of the answers inside the window."""
        t = self.times()
        return (t[:, 1] - t[:, 0])[t[:, 1] <= self.t_end]


class TimedIndex:
    """The tier behind a thin proxy: each call's rows and host-clock span."""

    def __init__(self, index):
        self.index = index
        self.calls: List[tuple] = []   # (rows passed, t0, t1)

    def search(self, queries, k: int):
        t0 = time.perf_counter()
        out = self.index.search(queries, k)
        self.calls.append((int(queries.shape[0]), t0, time.perf_counter()))
        return out


class ClosedLoop:
    def __init__(self, traffic: dict, tier, proxy: TimedIndex, pool: np.ndarray,
                 order: List[int], k: int):
        if traffic.get("kind") != "closed_loop":
            raise ValueError(f"unknown traffic kind {traffic.get('kind')!r}")
        self.clients = int(traffic["clients"])
        self.via = traffic["via"]
        if self.via == "index" and self.clients != 1:
            raise ValueError("a mix that calls the tier itself has one client")
        if self.via not in ("index", "service"):
            raise ValueError(f"unknown route {self.via!r}")
        self.proxy, self.pool, self.order, self.k = proxy, pool, order, int(k)
        self.service = None
        if self.via == "service":
            from codegraph_tpu_torch.search.service import QueryService

            policy = QueryService.policy_for(tier)
            self.service = QueryService(proxy, k=self.k, **policy)

    def query(self, client: int, j: int) -> int:
        return self.order[(client + self.clients * j) % len(self.order)]

    def warm(self, rounds: int = 3) -> None:
        """Run every shape this mix sends: B=1, or each of the service's
        padded batch shapes up to the first that holds every client, then
        whole rounds through the service."""
        if self.service is None:
            for j in range(rounds):
                self.proxy.search(self.pool[self.query(0, j)][None], self.k)
        else:
            shapes = [b for b in self.service.pad_buckets if b < self.clients]
            shapes.append(next(b for b in self.service.pad_buckets if b >= self.clients))
            for b in shapes:
                for _ in range(rounds):
                    self.proxy.search(self.pool[[self.query(c, 0) for c in range(b)]], self.k)
            for j in range(rounds):
                futs = [self.service.submit(self.pool[self.query(c, j)])
                        for c in range(self.clients)]
                for f in futs:
                    f.result(timeout=300)
        self.proxy.calls.clear()

    def run(self, seconds: float, annotate: bool = False) -> Outcome:
        if annotate:
            import torch

            with torch.profiler.record_function(WINDOW_SPAN):
                return self._run(seconds)
        return self._run(seconds)

    def _run(self, seconds: float) -> Outcome:
        if self.service is None:
            return self._direct(seconds)
        return self._through_service(seconds)

    def _direct(self, seconds: float) -> Outcome:
        t_start = time.perf_counter()
        out = Outcome(t_start, t_start + seconds, Answers(self.k))
        j = 0
        while True:
            qi = self.query(0, j)
            j += 1
            t0 = time.perf_counter()
            scores, ids = self.proxy.search(self.pool[qi][None], self.k)
            t1 = time.perf_counter()
            out.answers.add(qi, t0, t1, scores[0], ids[0])
            if t1 >= out.t_end:
                break
        out.attempted = j
        return out

    def _through_service(self, seconds: float) -> Outcome:
        from codegraph_tpu_torch.search.service import ServiceOverloaded

        svc = self.service
        lock = threading.Lock()
        idle = threading.Event()
        active = [self.clients]
        before = dict(vars(svc.stats))
        t_start = time.perf_counter()
        out = Outcome(t_start, t_start + seconds, Answers(self.k))

        def stop_client():
            with lock:
                active[0] -= 1
                if active[0] == 0:
                    idle.set()

        def send(c: int, j: int) -> None:
            qi = self.query(c, j)
            t0 = time.perf_counter()
            try:
                fut = svc.submit(self.pool[qi])
            except ServiceOverloaded:
                with lock:
                    out.attempted += 1
                    out.failed += 1
                stop_client()
                return
            with lock:
                out.attempted += 1
            fut.add_done_callback(lambda f: done(c, j, qi, t0, f))

        def done(c: int, j: int, qi: int, t0: float, fut) -> None:
            t1 = time.perf_counter()
            exc = fut.exception()
            if exc is None:
                scores, ids = fut.result()
                out.answers.add(qi, t0, t1, scores, ids)
            else:
                with lock:
                    if isinstance(exc, TimeoutError):
                        out.failed += 1
                    else:
                        out.errors.append(repr(exc))
            if t1 < out.t_end:
                send(c, j + 1)
            else:
                stop_client()

        for c in range(self.clients):
            send(c, 0)
        if not idle.wait(timeout=seconds + 120):
            with lock:
                out.unanswered = max(0, out.attempted - out.failed - len(out.errors)
                                     - out.answers.n)
        after = vars(svc.stats)
        out.service_stats = {key: after[key] - before[key] for key in ("queries", "batches",
                                                                        "shed", "expired")}
        return out

    def close(self) -> None:
        if self.service is not None:
            self.service.close()

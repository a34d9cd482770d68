"""Copy of `codegraph_tpu/utils/heartbeat.py` for the PyTorch port.

Heartbeat liveness monitor.

Reference: crates/codegraph-mcp/src/heartbeat.rs:9-284 — ping/pong with
a missed-count threshold flipping the peer to a Failed state (:26-31).
"""

from __future__ import annotations

import threading
import time
from enum import Enum
from typing import Callable, Optional


class LivenessState(str, Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    FAILED = "failed"


class HeartbeatMonitor:
    def __init__(
        self,
        interval_s: float = 5.0,
        max_missed: int = 3,
        on_failed: Optional[Callable[[], None]] = None,
        clock=time.monotonic,
    ):
        self.interval_s = interval_s
        self.max_missed = max_missed
        self.on_failed = on_failed
        self._clock = clock
        self._last_pong = clock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def pong(self) -> None:
        """Record a liveness signal from the monitored component."""
        self._last_pong = self._clock()

    @property
    def missed(self) -> int:
        return int((self._clock() - self._last_pong) // self.interval_s)

    @property
    def state(self) -> LivenessState:
        m = self.missed
        if m >= self.max_missed:
            return LivenessState.FAILED
        if m >= 1:
            return LivenessState.DEGRADED
        return LivenessState.HEALTHY

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                if self.state == LivenessState.FAILED and self.on_failed:
                    self.on_failed()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


__all__ = ["HeartbeatMonitor", "LivenessState"]

"""Copy of `codegraph_tpu/utils/circuit.py` for the PyTorch port.

Circuit breaker: Closed / Open / HalfOpen with exponential backoff.

Reference: codegraph-mcp-daemon/src/daemon/health.rs:14-184 —
failure_threshold trips the breaker, open state rejects work until a
backoff cooldown, half-open admits one probe; success closes, failure
re-opens with doubled backoff (capped).
"""

from __future__ import annotations

import time
from enum import Enum


class CircuitState(str, Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(
        self,
        failure_threshold: int = 5,
        backoff_base_s: float = 1.0,
        backoff_max_s: float = 60.0,
        clock=time.monotonic,
    ):
        self.failure_threshold = failure_threshold
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self._clock = clock
        self.state = CircuitState.CLOSED
        self.failures = 0
        self.consecutive_opens = 0
        self._open_until = 0.0
        self._probe_in_flight = False

    def should_allow_request(self) -> bool:
        """health.rs:78 — gate before processing a batch."""
        if self.state == CircuitState.CLOSED:
            return True
        now = self._clock()
        if self.state == CircuitState.OPEN:
            if now >= self._open_until:
                self.state = CircuitState.HALF_OPEN
                self._probe_in_flight = True
                return True
            return False
        # HALF_OPEN admits exactly ONE probe (health.rs semantics):
        # concurrent callers must not herd onto a still-failing backend
        if self._probe_in_flight:
            return False
        self._probe_in_flight = True
        return True

    def record_success(self) -> None:
        self.failures = 0
        self.consecutive_opens = 0
        self.state = CircuitState.CLOSED
        self._probe_in_flight = False

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == CircuitState.HALF_OPEN or (
            self.failures >= self.failure_threshold
        ):
            self._trip()

    def _trip(self) -> None:
        self.consecutive_opens += 1
        backoff = min(
            self.backoff_base_s * (2 ** (self.consecutive_opens - 1)),
            self.backoff_max_s,
        )
        self._open_until = self._clock() + backoff
        self.state = CircuitState.OPEN
        self.failures = 0
        self._probe_in_flight = False

    @property
    def cooldown_remaining_s(self) -> float:
        return max(0.0, self._open_until - self._clock())


__all__ = ["CircuitBreaker", "CircuitState"]

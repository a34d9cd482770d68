"""Copy of `codegraph_tpu/utils/perfmon.py` for the PyTorch port.

Performance monitor: moving averages, explicit targets, alerts.

Reference: crates/codegraph-core/src/performance_monitor.rs:10-622 —
PerformanceTargets with baseline->target pairs (:56-90: vector search
200->100 ms, node query 100->50 ms, 1k->2k QPS, 10k->20k nodes/s,
500->1000 embeddings/s), moving averages, threshold alerts (:144-170).
These targets double as the bench-harness regression gates.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass(frozen=True)
class Target:
    baseline: float
    target: float
    unit: str
    lower_is_better: bool = True


@dataclass(frozen=True)
class PerformanceTargets:
    """Baseline -> target pairs (performance_monitor.rs:56-90)."""

    vector_search_ms: Target = Target(200.0, 100.0, "ms")
    node_query_ms: Target = Target(100.0, 50.0, "ms")
    edge_traversal_ms: Target = Target(50.0, 25.0, "ms")
    rag_latency_ms: Target = Target(200.0, 100.0, "ms")
    query_qps: Target = Target(1000.0, 2000.0, "qps", lower_is_better=False)
    nodes_per_second: Target = Target(10_000.0, 20_000.0, "nodes/s", lower_is_better=False)
    embeddings_per_second: Target = Target(500.0, 1000.0, "emb/s", lower_is_better=False)


@dataclass
class MetricWindow:
    window: int = 100
    values: deque = field(default_factory=lambda: deque(maxlen=100))

    def record(self, v: float) -> None:
        self.values.append(v)

    @property
    def mean(self) -> float:
        return sum(self.values) / len(self.values) if self.values else 0.0

    @property
    def p95(self) -> float:
        if not self.values:
            return 0.0
        s = sorted(self.values)
        return s[min(len(s) - 1, int(0.95 * len(s)))]


class PerformanceMonitor:
    def __init__(self, targets: Optional[PerformanceTargets] = None,
                 on_alert: Optional[Callable[[str], None]] = None):
        self.targets = targets or PerformanceTargets()
        self.metrics: Dict[str, MetricWindow] = {}
        self.alerts: List[str] = []
        self._on_alert = on_alert

    def record(self, name: str, value: float) -> None:
        self.metrics.setdefault(name, MetricWindow()).record(value)
        target = getattr(self.targets, name, None)
        if isinstance(target, Target):
            bad = (
                value > target.baseline if target.lower_is_better
                else value < target.baseline
            )
            if bad:
                msg = (
                    f"{name}={value:.1f}{target.unit} misses baseline "
                    f"{target.baseline:.0f}{target.unit}"
                )
                self.alerts.append(msg)
                if self._on_alert:
                    self._on_alert(msg)

    def timer(self, name: str):
        """Context manager recording elapsed ms."""
        mon = self

        class _Timer:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                mon.record(name, (time.perf_counter() - self.t0) * 1000.0)
                return False

        return _Timer()

    def report(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, win in self.metrics.items():
            entry = {"mean": round(win.mean, 3), "p95": round(win.p95, 3),
                     "n": len(win.values)}
            target = getattr(self.targets, name, None)
            if isinstance(target, Target):
                entry["baseline"] = target.baseline
                entry["target"] = target.target
                meets = (
                    win.mean <= target.target if target.lower_is_better
                    else win.mean >= target.target
                )
                entry["meets_target"] = bool(meets)
            out[name] = entry
        return out


__all__ = ["PerformanceMonitor", "PerformanceTargets", "Target", "MetricWindow"]

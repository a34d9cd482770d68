"""Copy of `codegraph_tpu/mcp/coordination.py` for the PyTorch port.

Multi-agent coordination scaffolding.

Reference: crates/codegraph-mcp/src/coordination/mod.rs:13-586 —
AgentRegistry (:176) with capabilities, per-agent circuit state, task
specs, retry policies, and result aggregation/conflict policies
(:69-139). Host-side orchestration only; agents execute through their
own runtimes (mcp/agents.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List

from codegraph_tpu_torch.utils.circuit import CircuitBreaker


class AggregationPolicy(str, Enum):
    FIRST_SUCCESS = "first_success"
    ALL = "all"
    MAJORITY = "majority"


@dataclass
class TaskSpec:
    task_id: str
    description: str
    required_capabilities: List[str] = field(default_factory=list)
    max_retries: int = 1
    timeout_s: float = 120.0
    aggregation: AggregationPolicy = AggregationPolicy.FIRST_SUCCESS


@dataclass
class AgentEntry:
    name: str
    capabilities: List[str]
    run: Callable[[str], Any]  # task description -> result
    breaker: CircuitBreaker = field(default_factory=CircuitBreaker)
    completed: int = 0
    failed: int = 0

    def can_handle(self, spec: TaskSpec) -> bool:
        return set(spec.required_capabilities) <= set(self.capabilities)


@dataclass
class TaskResult:
    task_id: str
    agent: str
    ok: bool
    result: Any = None
    error: str = ""
    elapsed_s: float = 0.0


class AgentRegistry:
    def __init__(self) -> None:
        self.agents: Dict[str, AgentEntry] = {}

    def register(
        self, name: str, capabilities: List[str], run: Callable[[str], Any]
    ) -> AgentEntry:
        entry = AgentEntry(name=name, capabilities=capabilities, run=run)
        self.agents[name] = entry
        return entry

    def candidates(self, spec: TaskSpec) -> List[AgentEntry]:
        return [
            a for a in self.agents.values()
            if a.can_handle(spec) and a.breaker.should_allow_request()
        ]

    def stats(self) -> Dict[str, Dict]:
        return {
            name: {
                "capabilities": a.capabilities,
                "completed": a.completed,
                "failed": a.failed,
                "circuit": a.breaker.state.value,
            }
            for name, a in self.agents.items()
        }


class Coordinator:
    """Dispatch tasks to capable agents with retry + aggregation."""

    def __init__(self, registry: AgentRegistry):
        self.registry = registry
        self.history: List[TaskResult] = []

    def execute(self, spec: TaskSpec) -> List[TaskResult]:
        results: List[TaskResult] = []
        attempts = 0
        candidates = self.registry.candidates(spec)
        if not candidates:
            return [TaskResult(spec.task_id, "", False,
                               error="no capable agent available")]
        for agent in candidates:
            if spec.aggregation == AggregationPolicy.FIRST_SUCCESS and any(
                r.ok for r in results
            ):
                break
            while attempts <= spec.max_retries:
                attempts += 1
                t0 = time.perf_counter()
                try:
                    value = agent.run(spec.description)
                    agent.breaker.record_success()
                    agent.completed += 1
                    result = TaskResult(
                        spec.task_id, agent.name, True, result=value,
                        elapsed_s=time.perf_counter() - t0,
                    )
                    results.append(result)
                    break
                except Exception as exc:
                    agent.breaker.record_failure()
                    agent.failed += 1
                    results.append(TaskResult(
                        spec.task_id, agent.name, False, error=str(exc),
                        elapsed_s=time.perf_counter() - t0,
                    ))
            attempts = 0
        self.history.extend(results)
        return results

    def aggregate(self, spec: TaskSpec, results: List[TaskResult]) -> Any:
        """Conflict resolution per policy (coordination/mod.rs:69-139)."""
        ok = [r for r in results if r.ok]
        if not ok:
            return None
        if spec.aggregation == AggregationPolicy.FIRST_SUCCESS:
            return ok[0].result
        if spec.aggregation == AggregationPolicy.ALL:
            return [r.result for r in ok]
        # MAJORITY: most common result (by repr) wins
        from collections import Counter

        counted = Counter(repr(r.result) for r in ok)
        winner_repr, _ = counted.most_common(1)[0]
        return next(r.result for r in ok if repr(r.result) == winner_repr)


__all__ = [
    "AgentRegistry",
    "AgentEntry",
    "Coordinator",
    "TaskSpec",
    "TaskResult",
    "AggregationPolicy",
]

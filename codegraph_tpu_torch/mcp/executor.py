"""Copy of `codegraph_tpu/mcp/executor.py` for the PyTorch port.

Agent executor with session history.

Reference: codegraph-mcp-rig/src/agent/executor.rs:19-265 — RigExecutor
holds conversation history across tool-augmented turns, streams progress,
and counts tool usage. Host-side session wrapper over the agent runtimes
(mcp/agents.py): each `execute` turn sees a transcript of prior turns,
so follow-up questions resolve pronouns/context.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from codegraph_tpu_torch.mcp.agents import AgentResult, create_agent
from codegraph_tpu_torch.utils.debug_logger import DebugLogger


@dataclass
class Turn:
    question: str
    answer: str
    agent: str
    n_tools: int
    elapsed_s: float
    ts: float = field(default_factory=time.time)


class AgentExecutor:
    """Multi-turn session over one agent architecture."""

    def __init__(
        self,
        llm,
        tools,
        architecture: str = "react",
        max_history: int = 6,
        debug: Optional[DebugLogger] = None,
        on_progress: Optional[Callable[[str], None]] = None,
    ):
        self.llm = llm
        self.tools = tools
        self.architecture = architecture
        self.max_history = max_history
        self.debug = debug or DebugLogger()
        self.on_progress = on_progress
        self.history: List[Turn] = []

    def _context_prefix(self) -> str:
        if not self.history:
            return ""
        lines = ["Prior conversation:"]
        for turn in self.history[-self.max_history:]:
            lines.append(f"Q: {turn.question}")
            lines.append(f"A: {turn.answer[:400]}")
        return "\n".join(lines) + "\n\nCurrent question: "

    def execute(self, question: str) -> AgentResult:
        if self.on_progress:
            self.on_progress(f"running {self.architecture} agent")
        agent = create_agent(self.architecture, self.llm, self.tools)
        t0 = time.perf_counter()
        result = agent.run(self._context_prefix() + question)
        elapsed = time.perf_counter() - t0
        self.history.append(Turn(
            question=question, answer=result.answer, agent=result.agent,
            n_tools=len(result.traces), elapsed_s=elapsed,
        ))
        self.debug.log(
            "executor_turn", question=question, agent=result.agent,
            n_tools=len(result.traces), elapsed_s=round(elapsed, 3),
            succeeded=result.succeeded,
        )
        if self.on_progress:
            self.on_progress("synthesizing answer")
        return result

    def reset(self) -> None:
        self.history.clear()

    def stats(self) -> Dict[str, Any]:
        return {
            "turns": len(self.history),
            "total_tools": sum(t.n_tools for t in self.history),
            "avg_elapsed_s": (
                round(sum(t.elapsed_s for t in self.history)
                      / len(self.history), 3)
                if self.history else 0.0
            ),
        }


__all__ = ["AgentExecutor", "Turn"]

"""Copy of `codegraph_tpu/mcp/agents.py` for the PyTorch port.

Agent runtimes: ReAct, LATS tree search, Reflexion retry.

Re-implements the reference's agent crates: codegraph-mcp-rig
(agent/react.rs:20-188 ReAct loop over LLM tool calls, lats.rs:52
LatsAgent tree search, reflexion.rs:12 ReflexionAgent self-correcting
retry, executor.rs:19-265 RigExecutor with history) and the legacy
codegraph-mcp-autoagents LATS executor/search_tree. Agents are pure
host orchestration: the LLM proposes tool calls, GraphToolExecutor
answers from the TPU-backed graph/index, traces accumulate for the
structured synthesis step (official_server.rs:385-450).
"""

from __future__ import annotations

import json
import logging
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from codegraph_tpu_torch.core.errors import ProviderUnavailable
from codegraph_tpu_torch.mcp.llm import LLMProvider, ToolCall
from codegraph_tpu_torch.mcp.tools import TOOL_SCHEMAS, GraphToolExecutor
from codegraph_tpu_torch.utils.debug_logger import DebugLogger

logger = logging.getLogger("codegraph_tpu_torch.agents")


@dataclass
class ToolTrace:
    tool: str
    params: Dict[str, Any]
    result: Dict[str, Any]


@dataclass
class AgentResult:
    answer: str
    traces: List[ToolTrace] = field(default_factory=list)
    turns: int = 0
    agent: str = "react"
    succeeded: bool = True

    def structured(self) -> Dict[str, Any]:
        """Structured JSON synthesis from tool traces
        (official_server.rs:385-450)."""
        return {
            "answer": self.answer,
            "agent": self.agent,
            "turns": self.turns,
            "succeeded": self.succeeded,
            "evidence": [
                {"tool": t.tool, "params": t.params, "result": t.result}
                for t in self.traces
            ],
        }


_SYSTEM = (
    "You are a code-intelligence agent with access to a code knowledge "
    "graph. Use the tools to gather evidence, then answer concisely with "
    "file:line citations. Prefer semantic_code_search first to locate "
    "relevant code."
)


class ReActAgent:
    """Reason->act loop (react.rs:20-188): the LLM either calls a tool or
    produces the final answer; tool results feed back as messages."""

    name = "react"

    def __init__(
        self,
        llm: LLMProvider,
        tools: GraphToolExecutor,
        max_turns: int = 8,
        debug: Optional[DebugLogger] = None,
    ):
        self.llm = llm
        self.tools = tools
        self.max_turns = max_turns
        self.debug = debug or DebugLogger()

    def run(self, task: str, on_text=None) -> AgentResult:
        """on_text(fragment) streams the LLM's reasoning/answer text
        incrementally (reference: the rig executor's streaming path,
        codegraph-mcp-rig/src/agent/executor.rs:19-265)."""
        messages: List[Dict[str, Any]] = [
            {"role": "system", "content": _SYSTEM},
            {"role": "user", "content": task},
        ]
        schemas = list(TOOL_SCHEMAS.values())
        traces: List[ToolTrace] = []
        for turn in range(1, self.max_turns + 1):
            if on_text is not None:
                resp = self.llm.chat_stream(messages, schemas, on_text=on_text)
            else:
                resp = self.llm.chat_with_tools(messages, schemas)
            if resp.text:
                self.debug.reasoning(self.name, resp.text)
            if not resp.tool_calls:
                return AgentResult(resp.text, traces, turn, self.name)
            # execute every requested tool, append results. Models often
            # emit tool calls with NO text; the Anthropic Messages API
            # rejects empty assistant content (400), so synthesize a
            # transcript line describing the calls instead
            content = resp.text or "[calling tools: " + ", ".join(
                f"{tc.name}({json.dumps(tc.arguments, default=str)[:200]})"
                for tc in resp.tool_calls
            ) + "]"
            assistant_msg: Dict[str, Any] = {
                "role": "assistant", "content": content
            }
            messages.append(assistant_msg)
            for tc in resp.tool_calls:
                result = self.tools.execute(tc.name, tc.arguments)
                traces.append(ToolTrace(tc.name, tc.arguments, result))
                messages.append({
                    "role": "user",
                    "content": (
                        f"[tool result for {tc.name}]\n"
                        + json.dumps(result, default=str)[:8000]
                    ),
                })
        return AgentResult(
            "max turns reached without a final answer",
            traces, self.max_turns, self.name, succeeded=False,
        )


@dataclass
class LatsNode:
    """Search-tree node (autoagents lats/search_tree.rs:1-483)."""

    action: Optional[ToolTrace]
    parent: Optional["LatsNode"]
    children: List["LatsNode"] = field(default_factory=list)
    visits: int = 0
    value: float = 0.0
    depth: int = 0

    def ucb(self, c: float = 1.4) -> float:
        if self.visits == 0:
            return math.inf
        parent_visits = self.parent.visits if self.parent else self.visits
        return self.value / self.visits + c * math.sqrt(
            math.log(max(parent_visits, 1)) / self.visits
        )

    def path(self) -> List[ToolTrace]:
        out, node = [], self
        while node and node.action:
            out.append(node.action)
            node = node.parent
        return list(reversed(out))


class LatsAgent:
    """Language-Agent Tree Search (lats.rs:52): expand candidate tool
    actions, self-evaluate observations with the LLM, UCB-select the best
    branch, answer from the best path's evidence."""

    name = "lats"

    def __init__(
        self,
        llm: LLMProvider,
        tools: GraphToolExecutor,
        max_iterations: int = 6,
        expansion_width: int = 2,
        max_depth: int = 4,
        propose_llm: Optional[LLMProvider] = None,
        evaluate_llm: Optional[LLMProvider] = None,
        exploration_weight: float = 1.4,
    ):
        # per-phase LLM routing (reference: autoagents provider_router.rs
        # multi-LLM per LATS phase): a cheap model can propose/evaluate
        # while a strong one writes the final answer
        self.llm = llm
        self.propose_llm = propose_llm or llm
        self.evaluate_llm = evaluate_llm or llm
        self.tools = tools
        self.max_iterations = max_iterations
        self.expansion_width = expansion_width
        self.max_depth = max_depth
        self.exploration_weight = exploration_weight

    def _propose(self, task: str, history: List[ToolTrace]) -> List[ToolCall]:
        hist = "\n".join(
            f"- {t.tool}({json.dumps(t.params)}) -> "
            + json.dumps(t.result, default=str)[:300]
            for t in history
        ) or "(none yet)"
        prompt = (
            f"Task: {task}\nEvidence so far:\n{hist}\n\n"
            f"Propose up to {self.expansion_width} DIFFERENT next tool calls "
            "as a JSON array of {\"tool\": ..., \"params\": {...}}. "
            f"Available tools: {', '.join(TOOL_SCHEMAS)}. JSON only."
        )
        try:
            reply = self.propose_llm.complete(prompt)
            start, end = reply.find("["), reply.rfind("]")
            actions = json.loads(reply[start : end + 1])
            return [
                ToolCall(a["tool"], a.get("params", {}))
                for a in actions[: self.expansion_width]
                if isinstance(a, dict) and a.get("tool") in TOOL_SCHEMAS
            ]
        except Exception:
            return [ToolCall("semantic_code_search", {"query": task})]

    def _evaluate(self, task: str, trace: ToolTrace) -> float:
        prompt = (
            f"Task: {task}\nA tool call {trace.tool}({json.dumps(trace.params)}) "
            f"returned: {json.dumps(trace.result, default=str)[:600]}\n"
            "Rate 0-10 how useful this evidence is for the task. Number only."
        )
        try:
            reply = self.evaluate_llm.complete(prompt)
            for tok in reply.replace("/", " ").split():
                try:
                    return min(max(float(tok), 0.0), 10.0) / 10.0
                except ValueError:
                    continue
        except Exception:
            pass
        return 0.3 if "error" not in trace.result else 0.0

    def run(self, task: str) -> AgentResult:
        root = LatsNode(action=None, parent=None)
        for _ in range(self.max_iterations):
            # select: walk down by UCB
            node = root
            while node.children:
                node = max(
                    node.children,
                    key=lambda n: n.ucb(self.exploration_weight),
                )
            if node.depth >= self.max_depth:
                break
            # expand
            for tc in self._propose(task, node.path()):
                result = self.tools.execute(tc.name, tc.arguments)
                trace = ToolTrace(tc.name, tc.arguments, result)
                child = LatsNode(
                    action=trace, parent=node, depth=node.depth + 1
                )
                child.value = self._evaluate(task, trace)
                child.visits = 1
                node.children.append(child)
            # backprop best child value
            if node.children:
                best = max(node.children, key=lambda n: n.value)
                up, v = node, best.value
                while up is not None:
                    up.visits += 1
                    up.value += v
                    up = up.parent
        # best leaf path = evidence
        def best_leaf(n: LatsNode) -> LatsNode:
            return n if not n.children else best_leaf(
                max(n.children, key=lambda c: c.value / max(c.visits, 1))
            )

        traces = best_leaf(root).path()
        evidence = "\n".join(
            f"- {t.tool}: {json.dumps(t.result, default=str)[:500]}" for t in traces
        )
        try:
            answer = self.llm.complete(
                f"Task: {task}\nEvidence:\n{evidence}\n\n"
                "Write the final answer with citations."
            )
        except ProviderUnavailable:
            answer = evidence or "no evidence gathered"
        return AgentResult(answer, traces, len(traces), self.name)


class ReflexionAgent:
    """Retry-with-self-critique wrapper (reflexion.rs:12): when the inner
    agent fails or the self-check rejects the answer, re-run with the
    critique appended."""

    name = "reflexion"

    def __init__(self, inner, llm: LLMProvider, max_attempts: int = 2):
        self.inner = inner
        self.llm = llm
        self.max_attempts = max_attempts

    def run(self, task: str) -> AgentResult:
        critique = ""
        last: Optional[AgentResult] = None
        for attempt in range(self.max_attempts):
            full_task = task if not critique else (
                f"{task}\n\nPrevious attempt failed this review: {critique}\n"
                "Address the critique."
            )
            result = self.inner.run(full_task)
            result.agent = f"{self.name}({self.inner.name})"
            last = result
            if not result.succeeded:
                critique = "the agent ran out of turns without answering"
                continue
            try:
                verdict = self.llm.complete(
                    f"Task: {task}\nAnswer: {result.answer[:2000]}\n"
                    "Is this answer complete and grounded in the cited "
                    "evidence? Reply OK or a one-line critique."
                )
            except ProviderUnavailable:
                return result
            if verdict.strip().upper().startswith("OK"):
                return result
            critique = verdict.strip()
        return last if last is not None else AgentResult(
            "reflexion failed", [], 0, self.name, succeeded=False
        )


def _phase_llm(config, provider: str, model: str) -> Optional[LLMProvider]:
    """Build a per-phase LLM override (reference: autoagents
    provider_router.rs:266 routes each LATS phase to its own
    provider/model via CODEGRAPH_LATS_*_PROVIDER/_MODEL)."""
    if not provider and not model:
        return None
    import dataclasses as _dc

    from codegraph_tpu_torch.mcp.llm import create_llm

    cfg2 = _dc.replace(config)
    cfg2.llm = _dc.replace(
        config.llm,
        provider=provider or config.llm.provider,
        model=model or config.llm.model,
    )
    return create_llm(cfg2)


def create_agent(
    architecture: str,
    llm: LLMProvider,
    tools: GraphToolExecutor,
    config=None,
):
    """reference: CODEGRAPH_AGENT_ARCHITECTURE selects rig/react/lats
    (codegraph-mcp-core/src/agent_architecture.rs:8). With a
    CodeGraphConfig, LATS picks up beam/depth/UCB knobs and per-phase
    LLM routing from config.lats (CODEGRAPH_LATS_*)."""
    if architecture == "lats":
        if config is not None:
            lc = config.lats
            return LatsAgent(
                llm, tools,
                expansion_width=lc.beam_width,
                max_depth=lc.max_depth,
                exploration_weight=lc.exploration_weight,
                propose_llm=_phase_llm(
                    config, lc.expansion_provider, lc.expansion_model),
                evaluate_llm=_phase_llm(
                    config, lc.evaluation_provider, lc.evaluation_model),
            )
        return LatsAgent(llm, tools)
    if architecture == "reflexion":
        return ReflexionAgent(ReActAgent(llm, tools), llm)
    return ReActAgent(llm, tools)


__all__ = [
    "ToolTrace",
    "AgentResult",
    "ReActAgent",
    "LatsAgent",
    "LatsNode",
    "ReflexionAgent",
    "create_agent",
]

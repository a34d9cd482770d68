"""The port's MCP server and agents (host copies: `mcp/server.py`,
`mcp/agents.py`, `mcp/llm.py`, `mcp/executor.py`, `mcp/prompts.py`,
`mcp/tiers.py`), held to the JAX package on the CPU.

One snapshot, written by the JAX package with the hash provider (hash
embeddings are bitwise equal in both packages), is loaded into both. The JAX
server is built as its CLI builds it (`cli._make_server`); the port's by
`mcp.server.make_server`, which its CLI and `CodeGraph.serve` share. Every
JSON-RPC method then answers alike: replies equal exactly, except
`semantic_code_search` hits, whose scores are held to 1e-5 (f32 sums in
another order), whose ids may swap only where neighbouring scores tie within
1e-5, and whose `related` lists are compared as sets (equal-weight
neighbours are ordered by the g++ library's hash table, and by the JAX
package's Python loop where its library does not load).
The agents run under one scripted LLM on both sides and must give the same
traces, turns and answer.
"""

import io
import json
import os
import shutil
import sys

import pytest

from codegraph_tpu.api import CodeGraph as JCodeGraph
from codegraph_tpu.core.config import CodeGraphConfig as JConfig
from codegraph_tpu.mcp import agents as jag
from codegraph_tpu.mcp import executor as jex
from codegraph_tpu.mcp import llm as jllm
from codegraph_tpu.mcp import server as jsrv
from codegraph_tpu.mcp import tiers as jti
from codegraph_tpu.mcp.tools import GraphToolExecutor as JTools
from codegraph_tpu.search import reranker as jrr
from codegraph_tpu_torch.api import CodeGraph as TCodeGraph
from codegraph_tpu_torch.core.config import CodeGraphConfig as TConfig
from codegraph_tpu_torch.mcp import agents as tag
from codegraph_tpu_torch.mcp import executor as tex
from codegraph_tpu_torch.mcp import llm as tllm
from codegraph_tpu_torch.mcp import prompts as tpr
from codegraph_tpu_torch.mcp import server as tsrv
from codegraph_tpu_torch.mcp import tiers as tti

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(cls, data_dir, proj):
    cfg = cls()
    cfg.embedding.provider = "hash"
    cfg.embedding.fallbacks = []
    cfg.embedding.dimension = 256
    cfg.data_dir = str(data_dir)
    cfg.project_root = str(proj)
    return cfg


def _jax_server(j):
    """The JAX server as `codegraph_tpu/cli.py` `_make_server` builds it."""
    tools = JTools(j.graph, j.indexer.search,
                   jrr.make_reranker_pipeline(j.indexer.provider, j.config.search),
                   rerank_default=j.config.search.rerank)
    return jsrv.MCPServer(tools, j.config)


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    root = tmp_path_factory.mktemp("mcp")
    proj = root / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "mcp"), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))
    JCodeGraph.open(str(proj), config=_cfg(JConfig, root / "data", proj)).index()
    j = JCodeGraph(_cfg(JConfig, root / "data", proj))
    t = TCodeGraph(_cfg(TConfig, root / "data", proj), device="cpu")
    assert len(t.indexer.index) == len(j.indexer.index) > 50
    return {"j": j, "t": t, "js": _jax_server(j), "ts": tsrv.make_server(t.indexer, t.config), "proj": proj}


# -- comparing replies -------------------------------------------------------


def _related_key(entries):
    return sorted((e["name"], e["relation"], e["direction"], e["weight"]) for e in entries)


def _search_close(a, b, path, cap=8):
    assert sorted(a) == sorted(b) and a["count"] == b["count"], path
    ra, rb = a["results"], b["results"]
    scores = [r["score"] for r in ra]
    for i, (x, y) in enumerate(zip(ra, rb)):
        assert abs(x["score"] - y["score"]) <= TOL, (path, i)
        if x["node_id"] != y["node_id"]:
            # a swap of two nodes is allowed only where their scores tie
            assert any(abs(scores[n] - scores[i]) <= TOL
                       for n in (i - 1, i + 1) if 0 <= n < len(scores)), (path, i)
            continue
        assert sorted(x) == sorted(y), (path, i)
        for key in x:
            if key == "related":
                if len(x[key]) < cap and len(y[key]) < cap:
                    assert _related_key(x[key]) == _related_key(y[key]), (path, i)
                assert sorted(e["weight"] for e in x[key]) == \
                    sorted(e["weight"] for e in y[key]), (path, i)
            else:
                close(x[key], y[key], f"{path}[{i}].{key}")


def close(a, b, path="$"):
    """a (JAX) and b (port) equal, floats within TOL, search hits as above."""
    if isinstance(a, dict) and isinstance(a.get("results"), list) and "count" in a:
        _search_close(a, b, path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (path, sorted(a), b)
        for key in a:
            close(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, len(a), b)
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, (int, float)) and abs(a - b) <= TOL, (path, a, b)
    else:
        assert a == b, (path, a, b)


def reply_close(a, b):
    """Two JSON-RPC replies; a tools/call reply's text is parsed first."""
    if a is None or b is None:
        assert a is None and b is None
        return
    content = (a.get("result") or {}).get("content")
    if content:
        assert sorted(a) == sorted(b) and a["id"] == b["id"]
        assert a["result"]["isError"] == b["result"]["isError"]
        assert [c["type"] for c in content] == [c["type"] for c in b["result"]["content"]]
        close(json.loads(content[0]["text"]), json.loads(b["result"]["content"][0]["text"]))
    else:
        close(a, b)


def rpc(method, params=None, mid=1):
    msg = {"jsonrpc": "2.0", "method": method}
    if mid is not None:
        msg["id"] = mid
    if params is not None:
        msg["params"] = params
    return msg


def both(snap, msg, **kw):
    return snap["js"].handle_message(msg, **kw), snap["ts"].handle_message(msg, **kw)


# -- protocol ----------------------------------------------------------------


def test_constants_and_tool_list_equal():
    assert tsrv.PROTOCOL_VERSION == jsrv.PROTOCOL_VERSION
    assert tsrv.SERVER_INFO == jsrv.SERVER_INFO
    assert tsrv.AGENTIC_TOOLS == jsrv.AGENTIC_TOOLS
    assert tti.MCP_OUTPUT_TOKEN_CAP == jti.MCP_OUTPUT_TOKEN_CAP == 52_000


@pytest.mark.parametrize("msg", [
    rpc("initialize", {}),
    rpc("notifications/initialized", mid=None),
    rpc("ping"),
    rpc("tools/list"),
    rpc("prompts/list"),
    rpc("resources/list"),
    rpc("no/such/method", mid=7),
    rpc("notifications/unknown", mid=None),
], ids=lambda m: m["method"])
def test_protocol_methods_equal(snap, msg):
    a, b = both(snap, msg)
    assert a == b
    if msg.get("id") is not None:
        assert b["id"] == msg["id"]
    if msg["method"] == "tools/list":
        names = [t["name"] for t in b["result"]["tools"]]
        assert names[:4] == list(tsrv.AGENTIC_TOOLS) and len(names) == 13
    if msg["method"] == "resources/list":
        assert b["result"]["resources"]


def test_resources_read_equal(snap):
    files = [r["uri"] for r in snap["ts"].handle_message(rpc("resources/list"))["result"]["resources"]]
    uris = files[:3] + ["codegraph://file/nope.py", "file:///etc/hosts", ""]
    for uri in uris:
        a, b = both(snap, rpc("resources/read", {"uri": uri}))
        assert a == b, uri
    assert "result" in b or "error" in b
    first = snap["ts"].handle_message(rpc("resources/read", {"uri": files[0]}))
    assert first["result"]["contents"][0]["text"]


@pytest.mark.parametrize("name", [a.value for a in tpr.AnalysisType] + ["nope"])
def test_prompts_get_equal(snap, name):
    msg = rpc("prompts/get", {"name": name, "arguments": {"query": "how are tools called"}})
    a, b = both(snap, msg)
    assert a == b
    assert ("error" in b) == (name == "nope")


DIRECT_CALLS = [
    ("semantic_code_search", {"query": "dispatch a JSON-RPC tool call", "limit": 10}),
    ("semantic_code_search", {"query": "circuit breaker", "limit": 5, "rerank": False}),
    ("get_transitive_dependencies", {"node": "handle_message", "max_depth": 3}),
    ("detect_circular_dependencies", {}),
    ("trace_call_chain", {"source": "run", "max_depth": 4}),
    ("calculate_coupling_metrics", {"node": "create_llm"}),
    ("get_hub_nodes", {"limit": 10}),
    ("get_reverse_dependencies", {"node": "create_agent"}),
    ("find_nodes_by_name", {"name": "Agent", "limit": 10}),
    ("find_complexity_hotspots", {"limit": 10}),
    ("no_such_tool", {}),
]


@pytest.mark.parametrize("tool,args", DIRECT_CALLS, ids=[c[0] for c in DIRECT_CALLS])
def test_direct_tool_calls_equal(snap, tool, args):
    a, b = both(snap, rpc("tools/call", {"name": tool, "arguments": args}, mid=3))
    reply_close(a, b)
    assert b["result"]["isError"] == (tool == "no_such_tool")


AGENTIC = [(name, focus) for name in jsrv.AGENTIC_TOOLS for focus in ("", "call_chain")]


@pytest.mark.parametrize("name,focus", AGENTIC)
def test_agentic_pipeline_equal(snap, name, focus):
    """llm.provider = "none": each agentic tool runs its no-LLM pipeline."""
    args = {"query": "how does the server dispatch tools/call", "focus": focus}
    a, b = both(snap, rpc("tools/call", {"name": name, "arguments": args}, mid=4))
    reply_close(a, b)
    payload = json.loads(b["result"]["content"][0]["text"])
    assert payload["agent"] == "pipeline" and not b["result"]["isError"]
    assert [e["tool"] for e in payload["evidence"]] == jsrv.AGENTIC_TOOLS[name]["fallback"]


@pytest.mark.parametrize("name", ["agentic_quality", "semantic_code_search"])
def test_progress_notifications_equal(snap, name):
    params = {"name": name, "arguments": {"query": "complexity"}, "_meta": {"progressToken": "t1"}}
    na, nb = [], []
    a = snap["js"].handle_message(rpc("tools/call", params, mid=9), notify=na.append)
    b = snap["ts"].handle_message(rpc("tools/call", params, mid=9), notify=nb.append)
    reply_close(a, b)
    assert na == nb
    want = [10, 40, 100] if name.startswith("agentic") else [10, 100]
    assert [n["params"]["progress"] for n in nb] == want
    assert all(n["params"]["progressToken"] == "t1" for n in nb)


def test_output_cap_equal(snap, monkeypatch):
    """A result over 52k tokens (~4 chars a token) is cut with a marker."""
    big = {"blob": "x" * (tti.MCP_OUTPUT_TOKEN_CAP * 4 + 1000)}
    for side in ("js", "ts"):
        monkeypatch.setattr(snap[side].tools, "execute", lambda tool, params: dict(big))
    a, b = both(snap, rpc("tools/call", {"name": "get_hub_nodes", "arguments": {}}))
    assert a == b
    text = b["result"]["content"][0]["text"]
    assert len(text) > tti.MCP_OUTPUT_TOKEN_CAP * 4
    assert text.endswith(f"... [truncated at {tti.MCP_OUTPUT_TOKEN_CAP} tokens]")


def test_handler_error_becomes_32603(snap, monkeypatch):
    for side in ("js", "ts"):
        def boom():
            raise RuntimeError("list failed")
        monkeypatch.setattr(snap[side], "list_tools", boom)
    a, b = both(snap, rpc("tools/list", mid=5))
    assert a == b == {"jsonrpc": "2.0", "id": 5,
                      "error": {"code": -32603, "message": "RuntimeError: list failed"}}


def test_tool_exception_is_an_error_reply(snap, monkeypatch):
    """A search that raises comes back as isError: true, not as a raise."""
    for side in ("j", "t"):
        def boom(*a, **k):
            raise RuntimeError("search failed")
        monkeypatch.setattr(snap[side].indexer.search, "search_text", boom)
    msg = rpc("tools/call", {"name": "semantic_code_search",
                             "arguments": {"query": "a query never asked before"}})
    a, b = both(snap, msg)
    assert a == b and b["result"]["isError"]
    assert "RuntimeError: search failed" in b["result"]["content"][0]["text"]


def test_stdio_transport_equal(snap):
    lines = [
        json.dumps(rpc("initialize", {})), "", "not json",
        json.dumps(rpc("notifications/initialized", mid=None)),
        json.dumps(rpc("tools/list", mid=2)),
        json.dumps(rpc("tools/call", {"name": "semantic_code_search",
                                      "arguments": {"query": "stdio transport"},
                                      "_meta": {"progressToken": 3}}, mid=3)),
        json.dumps(rpc("tools/call", {"name": "agentic_context",
                                      "arguments": {"query": "stdio transport"}}, mid=4)),
        json.dumps(rpc("prompts/get", {"name": "code_search",
                                       "arguments": {"query": "stdio"}}, mid=5)),
    ]
    outs = []
    for side in ("js", "ts"):
        out = io.StringIO()
        snap[side].serve_stdio(io.StringIO("\n".join(lines) + "\n"), out)
        outs.append([json.loads(line) for line in out.getvalue().splitlines()])
    a, b = outs
    assert len(a) == len(b) == 7  # 5 replies + 2 progress notifications
    for x, y in zip(a, b):
        reply_close(x, y)
    assert [m.get("id") for m in b] == [1, 2, None, None, 3, 4, 5]


def test_codegraph_serve_equal(snap, monkeypatch):
    """`CodeGraph.serve` on both packages: stdio from sys.stdin, http on the
    configured host and port."""
    lines = json.dumps(rpc("initialize", {})) + "\n" + json.dumps(rpc("ping", mid=2)) + "\n"
    outs = []
    for side in ("j", "t"):
        out = io.StringIO()
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
        monkeypatch.setattr(sys, "stdout", out)
        snap[side].serve("stdio")
        monkeypatch.undo()
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and len(outs[1].splitlines()) == 2
    seen = []
    for mod in (jsrv, tsrv):
        monkeypatch.setattr(mod.MCPServer, "serve_http",
                            lambda self, host, port, auth_token=None: seen.append((host, port)))
    snap["j"].serve("http")
    snap["t"].serve("http")
    assert seen == [("127.0.0.1", 3003)] * 2
    assert type(snap["ts"].tools.reranker).__name__ == \
        type(snap["js"].tools.reranker).__name__


# -- agents under one scripted LLM -------------------------------------------


def scripted(mod, script, name="scripted"):
    """An LLMProvider of package `mod` (jllm or tllm) that replays `script`:
    a str is a text reply, a (tool, args) pair one tool call, a callable
    maps the last prompt to a text reply."""

    class Scripted(mod.LLMProvider):
        def __init__(self):
            self.script = list(script)
            self.prompts = []
            self.messages_seen = []

        def is_available(self):
            return True

        def chat_with_tools(self, messages, tools):
            self.prompts.append(messages[-1]["content"])
            self.messages_seen = [dict(m) for m in messages]
            if not self.script:
                return mod.ChatResponse(text="done")
            item = self.script.pop(0)
            if callable(item):
                return mod.ChatResponse(text=item(messages[-1]["content"]))
            if isinstance(item, str):
                return mod.ChatResponse(text=item)
            return mod.ChatResponse(text="", tool_calls=[mod.ToolCall(*item)])

    Scripted.name = name
    return Scripted()


def result_close(a, b):
    assert (a.agent, a.turns, a.succeeded, a.answer) == (b.agent, b.turns, b.succeeded, b.answer)
    close(a.structured(), b.structured())


REACT_SCRIPT = [
    ("semantic_code_search", {"query": "agent tool loop", "limit": 5}),
    ("get_transitive_dependencies", {"node": "create_agent"}),
    "create_agent picks the runtime; ReActAgent.run loops over tool calls.",
]


def test_react_agent_equal(snap):
    runs = []
    for mod, ag, side in ((jllm, jag, "js"), (tllm, tag, "ts")):
        llm = scripted(mod, REACT_SCRIPT)
        texts = []
        res = ag.ReActAgent(llm, snap[side].tools).run("how do agents run?", on_text=texts.append)
        runs.append((res, llm, texts))
    (a, la, ta), (b, lb, tb) = runs
    result_close(a, b)
    assert b.succeeded and b.turns == 3 and [t.tool for t in b.traces] == [
        "semantic_code_search", "get_transitive_dependencies"]
    assert ta == tb == [REACT_SCRIPT[-1]]
    assert [m["role"] for m in la.messages_seen] == [m["role"] for m in lb.messages_seen]
    assert all(m["content"] for m in lb.messages_seen if m["role"] == "assistant")


def test_react_agent_max_turns_equal(snap):
    script = [("get_hub_nodes", {"limit": 2})] * 10
    a = jag.ReActAgent(scripted(jllm, script), snap["js"].tools, max_turns=3).run("loop")
    b = tag.ReActAgent(scripted(tllm, script), snap["ts"].tools, max_turns=3).run("loop")
    result_close(a, b)
    assert not b.succeeded and b.turns == 3


def _lats_reply(prompt):
    if "Propose" in prompt:
        return json.dumps([
            {"tool": "semantic_code_search", "params": {"query": "tree search agent"}},
            {"tool": "get_hub_nodes", "params": {"limit": 3}},
            {"tool": "not_a_tool", "params": {}},
        ])
    if "Rate 0-10" in prompt:
        return "8/10" if "semantic_code_search" in prompt else "4"
    return "final: LatsAgent expands, evaluates and backs up values"


def test_lats_agent_equal(snap):
    a = jag.LatsAgent(scripted(jllm, [_lats_reply] * 40), snap["js"].tools,
                      max_iterations=3).run("how does LATS search?")
    b = tag.LatsAgent(scripted(tllm, [_lats_reply] * 40), snap["ts"].tools,
                      max_iterations=3).run("how does LATS search?")
    result_close(a, b)
    assert b.traces and b.answer.startswith("final:")


def test_lats_agent_bad_proposals_equal(snap):
    """Unparseable proposals fall back to one semantic search of the task;
    unparseable ratings to 0.3."""
    a = jag.LatsAgent(scripted(jllm, ["no json here"] * 20), snap["js"].tools,
                      max_iterations=2).run("reflexion critique")
    b = tag.LatsAgent(scripted(tllm, ["no json here"] * 20), snap["ts"].tools,
                      max_iterations=2).run("reflexion critique")
    result_close(a, b)
    assert [t.tool for t in b.traces] == ["semantic_code_search"] * len(b.traces)


def _critic(calls):
    def reply(prompt):
        calls.append(prompt)
        if "complete and grounded" in prompt:
            return "OK" if len(calls) > 3 else "missing citations"
        return f"answer v{len(calls)}"
    return reply


def test_reflexion_agent_equal(snap):
    res = []
    for mod, ag, side in ((jllm, jag, "js"), (tllm, tag, "ts")):
        calls = []
        llm = scripted(mod, [_critic(calls)] * 10)
        res.append(ag.ReflexionAgent(ag.ReActAgent(llm, snap[side].tools), llm,
                                     max_attempts=2).run("explain the executor"))
    result_close(*res)
    assert res[1].agent == "reflexion(react)" and res[1].succeeded


def test_agent_executor_equal(snap):
    out = []
    for mod, ex, side in ((jllm, jex, "js"), (tllm, tex, "ts")):
        llm = scripted(mod, [("find_nodes_by_name", {"name": "AgentExecutor"}),
                             "first answer about AgentExecutor", "second answer"])
        progress = []
        exe = ex.AgentExecutor(llm, snap[side].tools, architecture="react",
                               on_progress=progress.append)
        r1 = exe.execute("what does AgentExecutor do?")
        r2 = exe.execute("and who calls it?")
        stats = exe.stats()
        out.append((r1, r2, llm.prompts[-1], progress, stats["turns"], stats["total_tools"]))
        exe.reset()
        assert exe.stats()["turns"] == 0
    a, b = out
    result_close(a[0], b[0])
    result_close(a[1], b[1])
    assert a[2:] == b[2:]
    assert "Prior conversation" in b[2] and b[4:] == (2, 1)


@pytest.mark.parametrize("arch", ["react", "lats", "reflexion", "unknown"])
def test_create_agent_equal(snap, arch):
    cfg_j, cfg_t = snap["j"].config, snap["t"].config
    a = jag.create_agent(arch, scripted(jllm, []), snap["js"].tools, config=cfg_j)
    b = tag.create_agent(arch, scripted(tllm, []), snap["ts"].tools, config=cfg_t)
    assert type(a).__name__ == type(b).__name__
    if arch == "lats":
        knobs = ("expansion_width", "max_depth", "exploration_weight", "max_iterations")
        assert [getattr(a, k) for k in knobs] == [getattr(b, k) for k in knobs]


def test_lats_phase_llms_equal(snap):
    """Per-phase LLM routing from config.lats builds each phase's provider."""
    import copy

    cfgs = []
    for side in ("j", "t"):
        cfg = copy.deepcopy(snap[side].config)
        cfg.lats.expansion_provider = "anthropic"
        cfg.lats.evaluation_model = "small-model"
        cfgs.append(cfg)
    a = jag.create_agent("lats", scripted(jllm, []), snap["js"].tools, config=cfgs[0])
    b = tag.create_agent("lats", scripted(tllm, []), snap["ts"].tools, config=cfgs[1])
    assert (type(a.propose_llm).__name__, a.propose_llm.cfg.provider) == \
        (type(b.propose_llm).__name__, b.propose_llm.cfg.provider) == ("AnthropicProvider", "anthropic")
    assert (a.evaluate_llm.name, a.evaluate_llm.cfg.model) == \
        (b.evaluate_llm.name, b.evaluate_llm.cfg.model) == ("none", "small-model")
    assert tag._phase_llm(cfgs[1], "", "") is None


@pytest.mark.parametrize("arch", ["react", "lats", "reflexion"])
def test_agentic_tool_with_llm_equal(snap, monkeypatch, arch):
    """An available LLM drives the agentic tool through the configured
    architecture (not the no-LLM pipeline); streamed text arrives as
    notifications/message."""
    script = ([("semantic_code_search", {"query": "how agents are created", "limit": 3}),
               "agents come from create_agent", "OK"] if arch != "lats"
              else [_lats_reply] * 40)
    for side, mod in (("js", jllm), ("ts", tllm)):
        monkeypatch.setattr(snap[side], "llm", scripted(mod, script))
        monkeypatch.setattr(snap[side], "architecture", arch)
    msg = rpc("tools/call", {"name": "agentic_context",
                             "arguments": {"query": "how are agents created"},
                             "_meta": {"progressToken": "p"}}, mid=11)
    na, nb = [], []
    a = snap["js"].handle_message(msg, notify=na.append)
    b = snap["ts"].handle_message(msg, notify=nb.append)
    reply_close(a, b)
    assert na == nb
    payload = json.loads(b["result"]["content"][0]["text"])
    assert payload["agent"] == {"react": "react", "lats": "lats",
                                "reflexion": "reflexion(react)"}[arch]
    assert "semantic_code_search" in [e["tool"] for e in payload["evidence"]]
    if arch == "react":
        assert [n["params"]["data"] for n in nb if n["method"] == "notifications/message"] == [
            "agents come from create_agent"]


def test_agentic_tool_falls_back_on_provider_unavailable(snap, monkeypatch):
    """An LLM outage (ProviderUnavailable) drops to the no-LLM pipeline, as
    in the reference."""
    for side, mod in (("js", jllm), ("ts", tllm)):
        llm = scripted(mod, [])

        def down(messages, tools, _mod=mod):
            raise _mod.ProviderUnavailable("LLM request failed: down")
        llm.chat_with_tools = down
        monkeypatch.setattr(snap[side], "llm", llm)
    msg = rpc("tools/call", {"name": "agentic_impact", "arguments": {"query": "create_llm"}})
    a, b = both(snap, msg)
    reply_close(a, b)
    assert json.loads(b["result"]["content"][0]["text"])["agent"] == "pipeline"

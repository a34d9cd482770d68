"""Copy of `codegraph_tpu/mcp/server.py` for the PyTorch port, plus
`make_server`: the one build of a server from an indexer, which
`CodeGraph.serve` and the CLI's `_make_server` share (the JAX package builds
it in both places, `api.py:111-130` and `cli.py:107-118`, and the two builds
diverged twice). It passes no router, so the `model` tool parameter is
ignored, as it is in the JAX package's builds.

MCP protocol server: stdio + streamable-HTTP transports.

Reference: codegraph-mcp-server/src/official_server.rs:245-1286 — rmcp
server exposing 4 consolidated agentic tools (agentic_context /
agentic_impact / agentic_architecture / agentic_quality, :296-376) whose
`focus` maps to an AnalysisType, executed by execute_agentic_workflow
(:631: tier detect -> LLM factory -> agent executor -> structured JSON
from traces); http_server.rs axum streamable-HTTP at /mcp (port 3003).
This server speaks MCP JSON-RPC 2.0 (initialize / tools/list /
tools/call) directly; when no LLM is configured the agentic tools
degrade to a direct tool pipeline so the server is useful standalone.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any, Dict, List, Optional

from codegraph_tpu_torch.core.config import CodeGraphConfig
from codegraph_tpu_torch.core.errors import ProviderUnavailable
from codegraph_tpu_torch.mcp.agents import AgentResult, ToolTrace, create_agent
from codegraph_tpu_torch.mcp.llm import create_llm
from codegraph_tpu_torch.mcp.tiers import ContextTier, tier_limits
from codegraph_tpu_torch.mcp.tools import TOOL_SCHEMAS, GraphToolExecutor

logger = logging.getLogger("codegraph_tpu_torch.mcp")

PROTOCOL_VERSION = "2024-11-05"
SERVER_INFO = {"name": "codegraph-tpu", "version": "0.1.0"}

# the 4 consolidated tools (official_server.rs:296-376); focus values map
# to which direct tools the no-LLM fallback pipeline runs
AGENTIC_TOOLS: Dict[str, Dict[str, Any]] = {
    "agentic_context": {
        "description": "Gather rich context about a code area: semantic "
                       "search + dependencies + call chains.",
        "fallback": ["semantic_code_search", "get_transitive_dependencies",
                     "trace_call_chain"],
    },
    "agentic_impact": {
        "description": "Change-impact analysis: reverse dependencies + "
                       "coupling for the target.",
        "fallback": ["semantic_code_search", "get_reverse_dependencies",
                     "calculate_coupling_metrics"],
    },
    "agentic_architecture": {
        "description": "Architecture overview: hubs, cycles, top coupling.",
        "fallback": ["get_hub_nodes", "detect_circular_dependencies"],
    },
    "agentic_quality": {
        "description": "Quality analysis: complexity hotspots + cycles.",
        "fallback": ["find_complexity_hotspots",
                     "detect_circular_dependencies"],
    },
}


def _agentic_schema(name: str, desc: str) -> Dict[str, Any]:
    return {
        "name": name,
        "description": desc,
        "inputSchema": {
            "type": "object",
            "properties": {
                "query": {"type": "string",
                          "description": "the question or target area"},
                "focus": {"type": "string",
                          "description": "optional focus hint"},
            },
            "required": ["query"],
        },
    }


class MCPServer:
    """Protocol handler; transport-agnostic (`handle_message` takes/returns
    JSON-RPC dicts)."""

    def __init__(
        self,
        tools: GraphToolExecutor,
        config: Optional[CodeGraphConfig] = None,
    ):
        self.tools = tools
        self.config = config or CodeGraphConfig()
        self.llm = create_llm(self.config)
        self.tier = ContextTier.from_context_window(self.config.llm.context_window)
        self.initialized = False
        self._startup: Optional[str] = None
        # optional pre-built MetricsRegistry (serving wires QueryService
        # sources in before handing the registry to make_http_server)
        self.metrics_registry = None
        import os

        self.architecture = os.environ.get(
            "CODEGRAPH_AGENT_ARCHITECTURE", "react"
        )

    def _startup_context(self) -> str:
        """Project overview primed into agent tasks (reference:
        autoagents startup_context.rs:266 bootstrap context)."""
        if self._startup is None:
            try:
                q = self.tools.queries
                stats = q.store.stats()
                dirs = q.top_directories(limit=5)["directories"]
                hubs = q.hub_nodes(limit=5)["hubs"]
                parts = [
                    f"Project: {stats['nodes']} nodes, {stats['edges']} edges, "
                    f"{stats['files']} files indexed.",
                ]
                if dirs:
                    parts.append("Top directories: " + ", ".join(
                        f"{d['path'] or '.'} ({d['nodes']})" for d in dirs
                    ))
                if hubs:
                    parts.append("Hub symbols: " + ", ".join(
                        h["name"] for h in hubs
                    ))
                self._startup = " ".join(parts)
            except Exception:
                self._startup = ""
        return self._startup

    # -- tool surface ------------------------------------------------------

    def list_tools(self) -> List[Dict[str, Any]]:
        out = [
            _agentic_schema(name, spec["description"])
            for name, spec in AGENTIC_TOOLS.items()
        ]
        # direct tools are also exposed (the reference exposes consolidated
        # tools only, but direct access costs nothing and aids no-LLM use)
        for schema in TOOL_SCHEMAS.values():
            out.append({
                "name": schema["name"],
                "description": schema["description"],
                "inputSchema": schema["parameters"],
            })
        return out

    def call_tool(self, name: str, arguments: Dict[str, Any],
                  on_text=None) -> Dict[str, Any]:
        if name in AGENTIC_TOOLS:
            return self._agentic(name, arguments, on_text=on_text)
        return self.tools.execute(name, arguments)

    def _agentic(self, name: str, arguments: Dict[str, Any],
                 on_text=None) -> Dict[str, Any]:
        from codegraph_tpu_torch.mcp.prompts import (
            FOCUS_TO_ANALYSIS,
            AnalysisType,
            PromptSelector,
        )

        query = arguments.get("query", "")
        spec = AGENTIC_TOOLS[name]
        # focus -> AnalysisType -> tier-aware prompt (official_server.rs:306)
        default_analysis = {
            "agentic_context": AnalysisType.CONTEXT_BUILDER,
            "agentic_impact": AnalysisType.DEPENDENCIES,
            "agentic_architecture": AnalysisType.ARCHITECTURE,
            "agentic_quality": AnalysisType.COMPLEXITY,
        }[name]
        analysis = FOCUS_TO_ANALYSIS.get(
            str(arguments.get("focus", "")).lower(), default_analysis
        )
        task = PromptSelector(self.tier).select(analysis, query)
        startup = self._startup_context()
        if startup:
            task = f"{startup}\n\n{task}"
        if self.llm.is_available():
            try:
                agent = create_agent(self.architecture, self.llm, self.tools,
                                     config=self.config)
                try:
                    result = agent.run(task, on_text=on_text)
                except TypeError:  # agent without streaming support
                    result = agent.run(task)
                return result.structured()
            except ProviderUnavailable as exc:
                logger.warning("LLM unavailable, falling back: %s", exc)
        # no-LLM fallback: run the focus pipeline directly
        limits = tier_limits(self.tier)
        traces: List[ToolTrace] = []
        target = query
        for tool in spec["fallback"]:
            params: Dict[str, Any]
            if tool == "semantic_code_search":
                params = {"query": query, "limit": limits.search_limit}
            elif tool in ("get_transitive_dependencies",
                          "get_reverse_dependencies",
                          "calculate_coupling_metrics"):
                params = {"node": target}
            elif tool == "trace_call_chain":
                params = {"source": target}
            else:
                params = {}
            result = self.tools.execute(tool, params)
            traces.append(ToolTrace(tool, params, result))
            # seed later graph tools with the top search hit
            if tool == "semantic_code_search" and result.get("results"):
                target = result["results"][0]["name"]
        return AgentResult(
            answer=f"direct analysis for {query!r} (no LLM configured)",
            traces=traces, turns=len(traces), agent="pipeline",
        ).structured()

    # -- progress notifications (3-stage, progress_notifier.rs) -----------

    def _notify_progress(self, notify, token, progress: int, message: str):
        if notify is None or token is None:
            return
        notify({
            "jsonrpc": "2.0",
            "method": "notifications/progress",
            "params": {"progressToken": token, "progress": progress,
                       "total": 100, "message": message},
        })

    # -- JSON-RPC ----------------------------------------------------------

    def handle_message(
        self, msg: Dict[str, Any], notify=None
    ) -> Optional[Dict[str, Any]]:
        mid = msg.get("id")
        method = msg.get("method", "")
        params = msg.get("params") or {}

        def ok(result):
            return {"jsonrpc": "2.0", "id": mid, "result": result}

        def err(code, message):
            return {"jsonrpc": "2.0", "id": mid,
                    "error": {"code": code, "message": message}}

        try:
            if method == "initialize":
                self.initialized = True
                return ok({
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}, "prompts": {},
                                     "resources": {}},
                    "serverInfo": SERVER_INFO,
                })
            if method == "notifications/initialized":
                return None
            if method == "ping":
                return ok({})
            if method == "tools/list":
                return ok({"tools": self.list_tools()})
            if method == "resources/list":
                # indexed files as MCP resources, hub files first
                store = self.tools.queries.store
                hub_files = []
                try:
                    for h in self.tools.queries.hub_nodes(limit=10)["hubs"]:
                        if h["file_path"] not in hub_files:
                            hub_files.append(h["file_path"])
                except Exception:
                    pass
                files = hub_files + [
                    p for p in sorted(store.file_metadata) if p not in hub_files
                ]
                return ok({"resources": [
                    {"uri": f"codegraph://file/{p}", "name": p,
                     "mimeType": "text/plain"}
                    for p in files[:200]
                ]})
            if method == "resources/read":
                uri = params.get("uri", "")
                prefix = "codegraph://file/"
                if not uri.startswith(prefix):
                    return err(-32602, f"unknown resource uri: {uri}")
                path = uri[len(prefix):]
                store = self.tools.queries.store
                if path not in store.file_metadata:
                    return err(-32602, f"file not indexed: {path}")
                try:
                    with open(path, encoding="utf-8", errors="replace") as f:
                        text = f.read()
                except OSError as exc:
                    return err(-32603, f"read failed: {exc}")
                return ok({"contents": [{
                    "uri": uri, "mimeType": "text/plain", "text": text,
                }]})
            if method == "prompts/list":
                from codegraph_tpu_torch.mcp.prompts import AnalysisType

                return ok({"prompts": [
                    {
                        "name": at.value,
                        "description": f"Tier-aware {at.value} analysis prompt",
                        "arguments": [{
                            "name": "query", "required": True,
                            "description": "the question or target area",
                        }],
                    }
                    for at in AnalysisType
                ]})
            if method == "prompts/get":
                from codegraph_tpu_torch.mcp.prompts import (
                    AnalysisType,
                    PromptSelector,
                )

                name = params.get("name", "")
                try:
                    analysis = AnalysisType(name)
                except ValueError:
                    return err(-32602, f"unknown prompt: {name}")
                query = (params.get("arguments") or {}).get("query", "")
                text = PromptSelector(self.tier).select(analysis, query)
                return ok({
                    "description": f"{name} ({self.tier.value} tier)",
                    "messages": [{
                        "role": "user",
                        "content": {"type": "text", "text": text},
                    }],
                })
            if method == "tools/call":
                name = params.get("name", "")
                args = params.get("arguments") or {}
                token = (params.get("_meta") or {}).get("progressToken")
                self._notify_progress(notify, token, 10, f"starting {name}")
                if name in AGENTIC_TOOLS:
                    self._notify_progress(
                        notify, token, 40, "gathering graph evidence"
                    )
                on_text = None
                if notify is not None:
                    # stream LLM text fragments as logging notifications
                    # (delivered live on SSE transports)
                    def on_text(frag):
                        notify({
                            "jsonrpc": "2.0",
                            "method": "notifications/message",
                            "params": {"level": "info",
                                       "logger": "codegraph.agent",
                                       "data": frag},
                        })
                result = self.call_tool(name, args, on_text=on_text)
                self._notify_progress(notify, token, 100, "done")
                text = json.dumps(result, default=str, indent=2)
                # 52k-token MCP output cap (context_aware_limits.rs:8);
                # ~4 chars/token heuristic, truncation is explicit
                from codegraph_tpu_torch.mcp.tiers import MCP_OUTPUT_TOKEN_CAP

                cap_chars = MCP_OUTPUT_TOKEN_CAP * 4
                if len(text) > cap_chars:
                    text = (text[:cap_chars]
                            + f"\n... [truncated at {MCP_OUTPUT_TOKEN_CAP} tokens]")
                return ok({
                    "content": [{"type": "text", "text": text}],
                    "isError": "error" in result,
                })
            if mid is None:
                return None  # unknown notification: ignore
            return err(-32601, f"method not found: {method}")
        except Exception as exc:  # protocol-level resilience
            logger.exception("handler error")
            return err(-32603, f"{type(exc).__name__}: {exc}")

    # -- stdio transport (reference: stdio transport, transport.rs) --------

    def serve_stdio(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout

        def notify(notification):
            stdout.write(json.dumps(notification) + "\n")
            stdout.flush()

        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            reply = self.handle_message(msg, notify=notify)
            if reply is not None:
                stdout.write(json.dumps(reply) + "\n")
                stdout.flush()

    # -- streamable-HTTP transport (reference: http_server.rs:1-79, the
    # axum streamable-HTTP MCP endpoint at /mcp with session ids) ----------

    def make_http_server(self, host: str = "127.0.0.1", port: int = 3003,
                         auth_token: Optional[str] = None):
        """Build (not run) the streamable-HTTP server.

        MCP streamable-HTTP semantics:
        * POST /mcp — JSON-RPC. `initialize` mints a session and returns
          it in the `Mcp-Session-Id` response header; every subsequent
          request must echo that header (404 when unknown).
        * Clients that `Accept: text/event-stream` get an SSE response:
          notifications (progress + streamed LLM text) flush live as
          `data:` events, followed by the final JSON-RPC response.
        * DELETE /mcp — explicit session termination.
        * GET /mcp — 405 (no server-initiated stream; allowed by spec).
        * GET /metrics — Prometheus text exposition (reference ships the
          prometheus crate for its HTTP server, Cargo.toml:219); exports
          tool call counts, cache hit rates, perfmon windows, graph and
          index sizes via utils/metrics.py. An operator registers more
          sources on `self.metrics_registry` before building:
          `make_service_source(service)` for a QueryService's counters
          and, beside it, `make_span_source()` for the span recorder's
          totals by span name, full collections and dropped records
          (utils/perfmon.py). Unauthenticated by design
          (scrapers don't carry MCP bearer tokens; no request data is
          exposed).
        * Optional bearer auth: `auth_token` or CODEGRAPH_HTTP_TOKEN.
        """
        import os
        import uuid
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from codegraph_tpu_torch.utils.metrics import (
            MetricsRegistry,
            make_server_source,
        )

        server = self
        token = auth_token or os.environ.get("CODEGRAPH_HTTP_TOKEN", "")
        sessions: Dict[str, Dict[str, Any]] = {}
        registry = self.metrics_registry or MetricsRegistry()
        registry.register("mcp_server", make_server_source(self))

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _authed(self) -> bool:
                if not token:
                    return True
                return self.headers.get(
                    "Authorization", "") == f"Bearer {token}"

            def _session(self) -> Optional[str]:
                return self.headers.get("Mcp-Session-Id")

            def do_POST(self):
                if self.path.rstrip("/") not in ("/mcp", ""):
                    self.send_error(404)
                    return
                if not self._authed():
                    self.send_error(401)
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(length))
                except ValueError:
                    self.send_error(400)
                    return
                is_init = msg.get("method") == "initialize"
                sid = self._session()
                if is_init:
                    sid = uuid.uuid4().hex
                    sessions[sid] = {"created": True}
                elif sid is not None and sid not in sessions:
                    self.send_error(404, "unknown Mcp-Session-Id")
                    return
                accept = self.headers.get("Accept", "")
                if "text/event-stream" in accept and not is_init:
                    self._respond_sse(msg, sid)
                else:
                    reply = server.handle_message(msg)
                    self._respond_json(reply, sid)

            def _respond_json(self, reply, sid):
                body = json.dumps(reply or {}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                if sid:
                    self.send_header("Mcp-Session-Id", sid)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _respond_sse(self, msg, sid):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                if sid:
                    self.send_header("Mcp-Session-Id", sid)
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def emit(obj):
                    data = f"event: message\ndata: {json.dumps(obj)}\n\n"
                    raw = data.encode()
                    self.wfile.write(f"{len(raw):x}\r\n".encode())
                    self.wfile.write(raw + b"\r\n")
                    self.wfile.flush()

                reply = server.handle_message(msg, notify=emit)
                if reply is not None:
                    emit(reply)
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()

            def do_DELETE(self):
                if self.path.rstrip("/") not in ("/mcp", ""):
                    self.send_error(404)
                    return
                sid = self._session()
                if sid and sid in sessions:
                    del sessions[sid]
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_error(404)

            def do_GET(self):
                if self.path.split("?")[0].rstrip("/") == "/metrics":
                    body = registry.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                self.send_error(405)

            def log_message(self, *args):
                pass

        httpd = ThreadingHTTPServer((host, port), Handler)
        httpd._mcp_sessions = sessions  # test introspection
        httpd._metrics_registry = registry
        return httpd

    def serve_http(self, host: str = "127.0.0.1", port: int = 3003,
                   auth_token: Optional[str] = None) -> None:
        httpd = self.make_http_server(host, port, auth_token)
        logger.info("MCP streamable-HTTP server on %s:%d/mcp", host, port)
        httpd.serve_forever()


def make_server(indexer, config: CodeGraphConfig) -> MCPServer:
    """The MCP server over a ProjectIndexer: its graph, hybrid search and
    provider (for the reranker), on whatever device the indexer runs (the
    cross-encoder reranker too)."""
    from codegraph_tpu_torch.graph.queries import GraphQueries
    from codegraph_tpu_torch.search.reranker import make_reranker_pipeline

    tools = GraphToolExecutor(
        GraphQueries(indexer.store), indexer.search,
        make_reranker_pipeline(indexer.provider, config.search, device=indexer.device),
        rerank_default=config.search.rerank,
    )
    return MCPServer(tools, config)


__all__ = ["MCPServer", "AGENTIC_TOOLS", "PROTOCOL_VERSION", "make_server"]

"""The port's streamable-HTTP transport and `/metrics` (host copies:
`mcp/server.py` `make_http_server`, `utils/metrics.py`), held to the JAX
package on the CPU.

Both servers run on localhost, port 0, over one snapshot written by the JAX
package (hash provider). The same requests must give the same status codes,
headers that matter (`Mcp-Session-Id`, content types, chunked SSE) and
bodies; a `semantic_code_search` reply is compared as in
`tests/test_torch_mcp.py` (scores within 1e-5, swaps only where scores tie,
`related` as sets). `/metrics` renders the same sample names on both sides,
with the same values except the perfmon timing families (`perf_mean`,
`perf_p95`, `perf_meets_target`), which are wall-clock times.
"""

import http.client
import json
import os
import shutil
import socket
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from codegraph_tpu.api import CodeGraph as JCodeGraph
from codegraph_tpu.core.config import CodeGraphConfig as JConfig
from codegraph_tpu.mcp import server as jsrv
from codegraph_tpu.mcp.tools import GraphToolExecutor as JTools
from codegraph_tpu.search import reranker as jrr
from codegraph_tpu.utils import metrics as jmet
from codegraph_tpu_torch.api import CodeGraph as TCodeGraph
from codegraph_tpu_torch.core.config import CodeGraphConfig as TConfig
from codegraph_tpu_torch.mcp.server import make_server as tmake_server
from codegraph_tpu_torch.utils import metrics as tmet

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING_FAMILIES = ("codegraph_perf_mean", "codegraph_perf_p95", "codegraph_perf_meets_target")
SEARCH = {"name": "semantic_code_search",
          "arguments": {"query": "streamable HTTP session handling", "limit": 8}}


def _cfg(cls, data_dir, proj):
    cfg = cls()
    cfg.embedding.provider = "hash"
    cfg.embedding.fallbacks = []
    cfg.embedding.dimension = 256
    cfg.data_dir = str(data_dir)
    cfg.project_root = str(proj)
    return cfg


class Side:
    """One package's HTTP server on a free localhost port, in a thread."""

    def __init__(self, server, auth_token=None):
        self.server = server
        self.httpd = server.make_http_server("127.0.0.1", 0, auth_token=auth_token)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def request(self, method, path="/mcp", body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=60)
        try:
            data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
            conn.request(method, path, body=data,
                         headers={"Content-Type": "application/json", **(headers or {})})
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)


def _servers(j, t):
    jtools = JTools(j.graph, j.indexer.search,
                    jrr.make_reranker_pipeline(j.indexer.provider, j.config.search),
                    rerank_default=j.config.search.rerank)
    return jsrv.MCPServer(jtools, j.config), tmake_server(t.indexer, t.config)


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    root = tmp_path_factory.mktemp("http")
    proj = root / "proj"
    shutil.copytree(os.path.join(REPO, "codegraph_tpu", "utils"), proj,
                    ignore=shutil.ignore_patterns("__pycache__"))
    JCodeGraph.open(str(proj), config=_cfg(JConfig, root / "data", proj)).index()
    j = JCodeGraph(_cfg(JConfig, root / "data", proj))
    t = TCodeGraph(_cfg(TConfig, root / "data", proj), device="cpu")
    assert len(t.indexer.index) == len(j.indexer.index) > 20
    return {"j": j, "t": t, "proj": proj}


@pytest.fixture
def sides(snap):
    """Fresh servers (fresh tool caches and sessions) for each test."""
    js, ts = _servers(snap["j"], snap["t"])
    out = [Side(js), Side(ts)]
    yield out
    for s in out:
        s.close()


def _rpc(method, params=None, mid=1):
    msg = {"jsonrpc": "2.0", "id": mid, "method": method}
    if params is not None:
        msg["params"] = params
    return msg


def _search_close(a, b):
    assert a["count"] == b["count"] > 0
    scores = [r["score"] for r in a["results"]]
    for i, (x, y) in enumerate(zip(a["results"], b["results"])):
        assert abs(x["score"] - y["score"]) <= TOL
        if x["node_id"] != y["node_id"]:
            assert any(abs(scores[n] - scores[i]) <= TOL
                       for n in (i - 1, i + 1) if 0 <= n < len(scores))
            continue
        for key in x:
            if key == "related":
                assert sorted(e["weight"] for e in x[key]) == sorted(e["weight"] for e in y[key])
                if len(x[key]) < 8:
                    assert sorted(e["name"] for e in x[key]) == sorted(e["name"] for e in y[key])
            elif isinstance(x[key], float):
                assert abs(x[key] - y[key]) <= TOL, key
            else:
                assert x[key] == y[key], key


def _reply_close(a, b):
    """Two JSON-RPC replies (dicts); tools/call text is parsed first."""
    content = (a.get("result") or {}).get("content")
    if not content:
        assert a == b
        return
    assert a["id"] == b["id"] and a["result"]["isError"] == b["result"]["isError"]
    pa, pb = (json.loads(r["result"]["content"][0]["text"]) for r in (a, b))
    if "results" in pa:
        _search_close(pa, pb)
    else:
        assert pa == pb


def _session(side):
    status, headers, body = side.request("POST", body=_rpc("initialize", {}))
    assert status == 200
    return headers["Mcp-Session-Id"], json.loads(body)


def test_sessions_and_json_replies_equal(sides):
    (sid_j, init_j), (sid_t, init_t) = (_session(s) for s in sides)
    assert init_j == init_t
    assert len(sid_t) == 32 and int(sid_t, 16) >= 0
    assert sides[1].httpd._mcp_sessions == {sid_t: {"created": True}}
    replies = []
    for side, sid in zip(sides, (sid_j, sid_t)):
        out = []
        for msg in (_rpc("tools/list", mid=2), _rpc("tools/call", SEARCH, mid=3),
                    _rpc("ping", mid=4), _rpc("resources/list", mid=5)):
            status, headers, body = side.request("POST", body=msg,
                                                 headers={"Mcp-Session-Id": sid})
            assert status == 200 and headers["Content-Type"] == "application/json"
            assert headers["Mcp-Session-Id"] == sid
            out.append(json.loads(body))
        # a request without a session id is served (the session is optional)
        status, headers, body = side.request("POST", body=_rpc("ping", mid=6))
        assert status == 200 and "Mcp-Session-Id" not in headers
        out.append(json.loads(body))
        replies.append(out)
    for a, b in zip(*replies):
        _reply_close(a, b)


def test_status_codes_equal(sides):
    sids = [_session(s)[0] for s in sides]
    cases = [
        ("POST", "/mcp", _rpc("ping"), {"Mcp-Session-Id": "0" * 32}),   # unknown session
        ("POST", "/elsewhere", _rpc("ping"), {}),                        # wrong path
        ("POST", "/mcp", b"{not json", {}),                              # bad body
        ("GET", "/mcp", None, {}),                                       # no server stream
        ("DELETE", "/mcp", None, {"Mcp-Session-Id": "f" * 32}),          # unknown session
        ("DELETE", "/elsewhere", None, {}),
    ]
    got = [[s.request(*case)[0] for case in cases] for s in sides]
    assert got[0] == got[1] == [404, 404, 400, 405, 404, 404]
    # DELETE ends a session: 204, then the id is unknown (404 on use)
    for side, sid in zip(sides, sids):
        assert side.request("DELETE", headers={"Mcp-Session-Id": sid})[0] == 204
        assert side.request("DELETE", headers={"Mcp-Session-Id": sid})[0] == 404
        assert side.request("POST", body=_rpc("ping"), headers={"Mcp-Session-Id": sid})[0] == 404
        assert side.httpd._mcp_sessions == {}


def _sse_events(raw: bytes):
    """The JSON objects of an SSE body: `event: message` / `data: ...` blocks."""
    events = []
    for block in raw.decode().split("\n\n"):
        if not block.strip():
            continue
        lines = block.split("\n")
        assert lines[0] == "event: message" and lines[1].startswith("data: "), block
        events.append(json.loads(lines[1][len("data: "):]))
    return events


def _raw_chunked(side, msg, sid):
    """POST with Accept: text/event-stream over a raw socket; returns the
    response head and the chunk sizes and payloads as framed on the wire."""
    body = json.dumps(msg).encode()
    head = (f"POST /mcp HTTP/1.1\r\nHost: 127.0.0.1\r\nContent-Type: application/json\r\n"
            f"Accept: application/json, text/event-stream\r\nMcp-Session-Id: {sid}\r\n"
            f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode()
    with socket.create_connection(("127.0.0.1", side.port), timeout=60) as sock:
        sock.sendall(head + body)
        data = b""
        while True:
            part = sock.recv(65536)
            if not part:
                break
            data += part
    header, _, rest = data.partition(b"\r\n\r\n")
    chunks = []
    while True:
        size_line, _, rest = rest.partition(b"\r\n")
        size = int(size_line, 16)
        if size == 0:
            assert rest == b"\r\n"
            break
        chunks.append(rest[:size])
        assert rest[size:size + 2] == b"\r\n"
        rest = rest[size + 2:]
    return header.decode(), chunks


@pytest.mark.parametrize("name", ["semantic_code_search", "agentic_architecture"])
def test_sse_framing_equal(sides, name):
    args = SEARCH["arguments"] if name == "semantic_code_search" else {"query": "hubs"}
    msg = _rpc("tools/call", {"name": name, "arguments": args, "_meta": {"progressToken": 7}}, 3)
    framed = []
    for side in sides:
        sid = _session(side)[0]
        header, chunks = _raw_chunked(side, msg, sid)
        assert "Content-Type: text/event-stream" in header
        assert "Transfer-Encoding: chunked" in header and f"Mcp-Session-Id: {sid}" in header
        # one SSE event a chunk: the progress notifications, then the reply
        framed.append([_sse_events(c) for c in chunks])
    a, b = framed
    assert [len(e) for e in b] == [1] * len(b)
    a, b = [e[0] for e in a], [e[0] for e in b]
    want = [10, 40, 100] if name.startswith("agentic") else [10, 100]
    assert [e["params"]["progress"] for e in b[:-1]] == want
    assert a[:-1] == b[:-1] and b[-1]["id"] == 3
    _reply_close(a[-1], b[-1])


def test_initialize_is_never_streamed(sides):
    for side in sides:
        status, headers, body = side.request(
            "POST", body=_rpc("initialize", {}), headers={"Accept": "text/event-stream"})
        assert status == 200 and headers["Content-Type"] == "application/json"
        assert json.loads(body)["result"]["serverInfo"]["name"] == "codegraph-tpu"


@pytest.mark.parametrize("via_env", [False, True])
def test_bearer_auth_equal(snap, monkeypatch, via_env):
    if via_env:
        monkeypatch.setenv("CODEGRAPH_HTTP_TOKEN", "s3cret")
    servers = _servers(snap["j"], snap["t"])
    sides = [Side(s, auth_token=None if via_env else "s3cret") for s in servers]
    try:
        for side in sides:
            assert side.request("POST", body=_rpc("ping"))[0] == 401
            assert side.request("POST", body=_rpc("ping"),
                                headers={"Authorization": "Bearer wrong"})[0] == 401
            status, _, body = side.request("POST", body=_rpc("ping"),
                                           headers={"Authorization": "Bearer s3cret"})
            assert status == 200 and json.loads(body) == {"jsonrpc": "2.0", "id": 1, "result": {}}
            # scrapers carry no MCP token: /metrics stays open
            assert side.request("GET", "/metrics")[0] == 200
    finally:
        for side in sides:
            side.close()


def _samples(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        name, value = line.rsplit(" ", 1)
        out[name] = float(value)
    return out


def test_metrics_equal(sides):
    calls = [SEARCH, SEARCH, {"name": "get_hub_nodes", "arguments": {"limit": 5}},
             {"name": "find_nodes_by_name", "arguments": {"name": "Metrics"}},
             {"name": "no_such_tool", "arguments": {}}]
    texts = []
    for side in sides:
        for i, params in enumerate(calls):
            assert side.request("POST", body=_rpc("tools/call", params, mid=i))[0] == 200
        status, headers, body = side.request("GET", "/metrics?x=1")
        assert status == 200 and headers["Content-Type"] == "text/plain; version=0.0.4"
        texts.append(body.decode())
    a, b = (_samples(t) for t in texts)
    assert sorted(a) == sorted(b)
    assert [ln for ln in texts[0].splitlines() if ln.startswith("# TYPE")] == \
        [ln for ln in texts[1].splitlines() if ln.startswith("# TYPE")]
    for name in a:
        if not name.startswith(TIMING_FAMILIES):
            assert a[name] == b[name], name
    assert b['codegraph_tool_calls_total{tool="semantic_code_search"}'] == 2
    assert b["codegraph_tool_cache_hits"] == 1
    assert b["codegraph_index_rows"] > 20 and b["codegraph_graph_nodes"] > 20
    # an index without `generation`/`reloads` gives neither sample, on both sides
    assert not any("generation" in n or "reloads" in n for n in b)


def test_concurrent_calls_equal_serial(sides):
    """Requests on their own threads (ThreadingHTTPServer) give the serial
    replies: nothing on the served path is shared between calls."""
    side = sides[1]
    queries = ["HTTP session", "metrics registry render", "perfmon window", "progress line"]
    msgs = [_rpc("tools/call", {"name": "semantic_code_search",
                                "arguments": {"query": q, "limit": 5}}, mid=i)
            for i, q in enumerate(queries)]
    serial = [json.loads(side.request("POST", body=m)[2]) for m in msgs]
    side.server.tools.invalidate()  # the concurrent calls search again
    with ThreadPoolExecutor(len(msgs)) as pool:
        conc = list(pool.map(lambda m: json.loads(side.request("POST", body=m)[2]), msgs))
    assert conc == serial


def test_registry_render_equal():
    """The renderer alone: labels, escaping, counters, disambiguated
    families, a broken source and unregister."""
    def source():
        return {"requests_total__a": (3, {"route": "a\"b"}), "requests_total__b": (4, {"route": "x\ny"}),
                "queue depth": 2.5, "1bad-name": 7, "skipped": "text", "flag": True}

    out = []
    for mod in (jmet, tmet):
        reg = mod.MetricsRegistry()
        reg.register("src", source)
        reg.register("broken", lambda: 1 / 0)
        reg.register("gone", lambda: {"x": 1})
        reg.unregister("gone")
        out.append(reg.render())
    assert out[0] == out[1]
    assert 'codegraph_source_error{source="broken"} 1' in out[1]
    assert '# TYPE codegraph_requests_total counter' in out[1]


def test_service_source_equal():
    """make_service_source over each package's QueryService on the same
    16 x 16 corpus: the same samples."""
    from codegraph_tpu.index.flat import FlatIndex as JFlat
    from codegraph_tpu.search.service import QueryService as JService
    from codegraph_tpu_torch.index.flat import FlatIndex as TFlat
    from codegraph_tpu_torch.search.service import QueryService as TService

    x = np.eye(16, dtype=np.float32)
    jidx = JFlat(16, tile_n=128, backend="xla")
    jidx.add(x)
    tidx = TFlat(16, device="cpu")
    tidx.add(x)
    texts = []
    for svc in (JService(jidx, k=2, max_batch=4, max_wait_ms=1.0),
                TService(tidx, k=2, max_batch=4, max_wait_ms=1.0)):
        try:
            svc.search(x[0])
            svc.search(x[3])
            reg = (jmet if isinstance(svc, JService) else tmet).MetricsRegistry()
            reg.register("qsvc", (jmet if isinstance(svc, JService) else tmet)
                         .make_service_source(svc))
            texts.append(reg.render())
        finally:
            svc.close()
    assert texts[0] == texts[1]
    assert "codegraph_service_queries_total 2" in texts[1]
    assert "codegraph_service_queue_depth 0" in texts[1]

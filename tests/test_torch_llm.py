"""The port's LLM providers (host copy: `mcp/llm.py`), held to the JAX
package on the CPU, with no network: request bodies through a monkeypatched
`_post_json`, streaming against an SSE fake on localhost, the retry rules
through a monkeypatched `urlopen`. Every comparison is exact: the same
inputs must give the same URL, body, headers, ChatResponse, streamed
fragments, attempt count and error text.
"""

import dataclasses
import io
import json
import threading
import urllib.error
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from codegraph_tpu.core import config as jconfig
from codegraph_tpu.mcp import llm as jllm
from codegraph_tpu_torch.core import config as tconfig
from codegraph_tpu_torch.mcp import llm as tllm

SIDES = [(jllm, jconfig), (tllm, tconfig)]
MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "which function adds numbers?"}]
TOOLS = [{"name": "semantic_code_search", "description": "search",
          "parameters": {"type": "object", "properties": {"query": {"type": "string"}}}},
         {"name": "get_hub_nodes", "parameters": {"type": "object"}}]


def _asdict(resp):
    return dataclasses.asdict(resp)


@pytest.fixture
def capture(monkeypatch):
    """Each side's `_post_json` replaced by a recorder returning `response`."""
    calls = {"jllm": [], "tllm": [], "response": {}}
    for mod, key in ((jllm, "jllm"), (tllm, "tllm")):
        def fake(url, body, headers, timeout=120.0, retries=2, _key=key):
            calls[_key].append({"url": url, "body": json.loads(json.dumps(body)),
                                "headers": dict(headers)})
            return json.loads(json.dumps(calls["response"]))
        monkeypatch.setattr(mod, "_post_json", fake)
    return calls


def _chat(kind, llm_cfg, messages=MESSAGES, tools=TOOLS):
    out = []
    for mod, cfgmod in SIDES:
        provider = getattr(mod, kind)(cfgmod.LLMConfig(**llm_cfg))
        out.append(_asdict(provider.chat_with_tools(messages, tools)))
    return out


ANTHROPIC_REPLY = {
    "content": [{"type": "text", "text": "thinking..."},
                {"type": "tool_use", "id": "t1", "name": "semantic_code_search",
                 "input": {"query": "add"}},
                {"type": "tool_use", "id": "t2", "name": "get_hub_nodes"}],
    "stop_reason": "tool_use", "usage": {"input_tokens": 10, "output_tokens": 4},
}
OPENAI_REPLY = {
    "choices": [{"message": {"content": None, "tool_calls": [
        {"id": "c1", "function": {"name": "get_hub_nodes", "arguments": json.dumps({"limit": 3})}},
        {"id": "c2", "function": {"name": "semantic_code_search", "arguments": "{bad"}}]},
        "finish_reason": "tool_calls"}],
    "usage": {"prompt_tokens": 5},
}


@pytest.mark.parametrize("llm_cfg,tools", [
    ({"provider": "anthropic", "model": "m", "max_tokens": 128}, TOOLS),
    ({"provider": "anthropic", "base_url": "http://127.0.0.1:9/", "api_key_env": "MY_KEY"}, []),
])
def test_anthropic_requests_equal(capture, monkeypatch, llm_cfg, tools):
    monkeypatch.setenv("ANTHROPIC_API_KEY", "k1")
    monkeypatch.setenv("MY_KEY", "k2")
    capture["response"] = ANTHROPIC_REPLY
    a, b = _chat("AnthropicProvider", llm_cfg, tools=tools)
    assert a == b
    assert capture["jllm"] == capture["tllm"]
    req = capture["tllm"][0]
    assert req["url"].endswith("/v1/messages") and req["body"]["system"] == "be brief"
    assert req["headers"]["anthropic-version"] == "2023-06-01"
    assert [c["name"] for c in b["tool_calls"]] == ["semantic_code_search", "get_hub_nodes"]


@pytest.mark.parametrize("kind,llm_cfg", [
    ("OpenAICompatibleProvider", {"provider": "openai", "model": "gpt"}),
    ("OpenAICompatibleProvider", {"provider": "openai_compatible", "model": "local",
                                  "base_url": "http://127.0.0.1:9/v1/"}),
    ("OllamaProvider", {"provider": "ollama", "model": "llama"}),
    ("OllamaProvider", {"provider": "ollama", "base_url": "http://127.0.0.1:9"}),
])
def test_openai_dialect_requests_equal(capture, monkeypatch, kind, llm_cfg):
    monkeypatch.setenv("OPENAI_API_KEY", "ok")
    monkeypatch.setenv("OLLAMA_HOST", "http://127.0.0.1:8")
    capture["response"] = OPENAI_REPLY
    a, b = _chat(kind, llm_cfg)
    assert a == b
    assert capture["jllm"] == capture["tllm"]
    req = capture["tllm"][0]
    assert req["url"].endswith("/chat/completions")
    assert req["body"]["tools"][0] == {"type": "function", "function": TOOLS[0]}
    # malformed tool arguments degrade to {} rather than raise
    assert [c["arguments"] for c in b["tool_calls"]] == [{"limit": 3}, {}]


def test_openai_no_key_sends_no_auth(capture, monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    monkeypatch.setattr(tconfig, "CONFIG_DIR", tconfig.CONFIG_DIR.parent / "no-such-config-dir")
    monkeypatch.setattr(jconfig, "CONFIG_DIR", tconfig.CONFIG_DIR)
    capture["response"] = {"choices": [{"message": {"content": "hi"}, "finish_reason": "stop"}]}
    a, b = _chat("OpenAICompatibleProvider", {"provider": "openai", "base_url": "http://x/v1"},
                 tools=[])
    assert a == b and b["text"] == "hi"
    assert capture["tllm"][0]["headers"] == capture["jllm"][0]["headers"] == {}
    assert "tools" not in capture["tllm"][0]["body"]


def test_complete_and_chat_equal(capture, monkeypatch):
    monkeypatch.setenv("ANTHROPIC_API_KEY", "k")
    capture["response"] = {"content": [{"type": "text", "text": "42"}], "stop_reason": "end_turn"}
    got = [(p.complete("q"), _asdict(p.chat([{"role": "user", "content": "q"}])))
           for p in (mod.AnthropicProvider(cfg.LLMConfig(provider="anthropic"))
                     for mod, cfg in SIDES)]
    assert got[0] == got[1] and got[1][0] == "42"
    assert capture["jllm"] == capture["tllm"]


# -- streaming against a localhost SSE fake ---------------------------------


def _anthropic_events():
    return [
        {"type": "message_start"},
        {"type": "content_block_start", "index": 0, "content_block": {"type": "text"}},
        {"type": "content_block_delta", "index": 0, "delta": {"type": "text_delta", "text": "The "}},
        {"type": "content_block_delta", "index": 0, "delta": {"type": "text_delta", "text": "answer"}},
        {"type": "content_block_start", "index": 1,
         "content_block": {"type": "tool_use", "name": "get_hub_nodes", "id": "tu1"}},
        {"type": "content_block_delta", "index": 1,
         "delta": {"type": "input_json_delta", "partial_json": "{\"limit\""}},
        {"type": "content_block_delta", "index": 1,
         "delta": {"type": "input_json_delta", "partial_json": ": 4}"}},
        {"type": "content_block_start", "index": 2,
         "content_block": {"type": "tool_use", "name": "semantic_code_search", "id": "tu2"}},
        {"type": "content_block_delta", "index": 2,
         "delta": {"type": "input_json_delta", "partial_json": "{broken"}},
        {"type": "message_delta", "delta": {"stop_reason": "tool_use"},
         "usage": {"output_tokens": 9}},
    ]


def _openai_chunks():
    return [
        {"choices": [{"delta": {"content": "Hel"}}]},
        {"choices": [{"delta": {"content": "lo"}}]},
        {"choices": [{"delta": {"tool_calls": [{"index": 0, "id": "c1",
                                                "function": {"name": "get_hub_nodes",
                                                             "arguments": "{\"li"}}]}}]},
        {"choices": [{"delta": {"tool_calls": [{"index": 0,
                                                "function": {"arguments": "mit\": 2}"}}]}}]},
        {"choices": [{"delta": {}, "finish_reason": "tool_calls"}], "usage": {"total_tokens": 7}},
    ]


class _FakeLLM(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    seen = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        type(self).seen.append((self.path, body, self.headers.get("Accept")))
        events = _anthropic_events() if self.path.endswith("/v1/messages") else _openai_chunks()
        lines = [": keep-alive", "", "data: not json", ""]
        for ev in events:
            lines += [f"data: {json.dumps(ev)}", ""]
        lines += ["data: [DONE]", ""]
        raw = ("\n".join(lines) + "\n").encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)

    def do_GET(self):  # Ollama's /api/tags liveness probe
        self.send_response(200 if self.path == "/api/tags" else 404)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"{}")

    def log_message(self, *args):
        pass


@pytest.fixture
def fake_llm():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _FakeLLM)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    _FakeLLM.seen = []
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)


@pytest.mark.parametrize("kind,provider", [
    ("AnthropicProvider", "anthropic"),
    ("OpenAICompatibleProvider", "openai_compatible"),
])
def test_stream_equal(fake_llm, monkeypatch, kind, provider):
    monkeypatch.setenv("ANTHROPIC_API_KEY", "k")
    base = fake_llm + ("/v1" if provider != "anthropic" else "")
    got = []
    for mod, cfg in SIDES:
        frags = []
        p = getattr(mod, kind)(cfg.LLMConfig(provider=provider, base_url=base, model="m"))
        assert p.supports_streaming
        got.append((_asdict(p.chat_stream(MESSAGES, TOOLS, on_text=frags.append)), frags))
    assert got[0] == got[1]
    resp, frags = got[1]
    assert "".join(frags) == resp["text"] and len(frags) == 2
    assert resp["tool_calls"][0]["name"] == "get_hub_nodes"
    assert resp["tool_calls"][0]["arguments"] in ({"limit": 4}, {"limit": 2})
    (_, jbody, jacc), (_, tbody, tacc) = _FakeLLM.seen
    assert jbody == tbody and tbody["stream"] is True
    assert jacc == tacc == "text/event-stream"


def test_stream_failure_raises_provider_unavailable(monkeypatch):
    """A refused connection is an LLM outage on both sides."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]  # nothing listens here once closed
    msgs = []
    for mod, cfg in SIDES:
        p = mod.OpenAICompatibleProvider(cfg.LLMConfig(provider="openai_compatible",
                                                       base_url=f"http://127.0.0.1:{port}/v1"))
        with pytest.raises(mod.ProviderUnavailable) as exc:
            p.chat_stream(MESSAGES, (), on_text=None)
        msgs.append(str(exc.value).split(":")[0])
    assert msgs[0] == msgs[1] == "LLM stream failed"


def test_buffered_stream_of_base_provider_equal():
    """A provider without native SSE emits its whole text once."""
    got = []
    for mod, cfg in SIDES:
        class Canned(mod.LLMProvider):
            def chat_with_tools(self, messages, tools, _mod=mod):
                return _mod.ChatResponse(text="whole", stop_reason="end")
        frags = []
        got.append((_asdict(Canned(cfg.LLMConfig()).chat_stream(MESSAGES, on_text=frags.append)),
                    frags))
    assert got[0] == got[1] and got[1][1] == ["whole"]


def test_ollama_availability_equal(fake_llm):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = f"http://127.0.0.1:{s.getsockname()[1]}"
    for base, want in ((fake_llm, True), (dead, False)):
        got = [mod.OllamaProvider(cfg.LLMConfig(provider="ollama", base_url=base)).is_available()
               for mod, cfg in SIDES]
        assert got == [want, want]
        assert tllm.OllamaProvider(tconfig.LLMConfig(base_url=base))._base() == base + "/v1"


# -- retry rules --------------------------------------------------------------


def _http_error(code, body):
    def raise_(req, timeout=0):
        raise urllib.error.HTTPError(req.full_url, code, "reason", {}, io.BytesIO(body))
    return raise_


@pytest.mark.parametrize("outcomes,retries", [
    ([_http_error(400, b'{"error": "tools[0] invalid"}')], 2),   # 4xx: no retry
    ([_http_error(401, b"")], 2),                                # empty body: the reason
    ([_http_error(429, b"slow down")] * 3, 2),                   # 429: retried
    ([_http_error(503, b"busy")] * 2, 1),                        # 5xx: retried
    ([urllib.error.URLError("refused")] * 3, 2),                 # transport errors: retried
    ([_http_error(500, b"x"), {"ok": 1}], 2),                    # success after a failure
])
def test_post_json_retry_rules_equal(monkeypatch, outcomes, retries):
    results = []
    for mod, _ in SIDES:
        seq, attempts, sleeps = list(outcomes), [], []

        def fake_urlopen(req, timeout=0, _seq=seq):
            attempts.append((req.full_url, req.data, dict(req.header_items())))
            item = _seq.pop(0)
            if isinstance(item, Exception):
                raise item
            if callable(item):
                return item(req, timeout)
            return io.BytesIO(json.dumps(item).encode())

        monkeypatch.setattr(mod.urllib.request, "urlopen", fake_urlopen)
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)
        try:
            out = ("ok", mod._post_json("https://llm.invalid/v1", {"a": 1}, {"X": "y"},
                                        retries=retries))
        except mod.ProviderUnavailable as exc:
            out = ("unavailable", str(exc))
        results.append((out, attempts, sleeps))
    assert results[0] == results[1]
    out, attempts, sleeps = results[1]
    assert len(attempts) == len(outcomes)
    if out[0] == "unavailable":
        assert out[1].startswith("LLM request failed: ")


def test_create_llm_equal():
    names = ["anthropic", "openai", "openai_compatible", "xai", "lmstudio", "ollama", "none",
             "unknown"]
    for name in names:
        got = []
        for mod, cfg in SIDES:
            c = cfg.CodeGraphConfig()
            c.llm.provider = name
            llm = mod.create_llm(c)
            got.append((type(llm).__name__, llm.name, llm.supports_streaming))
        assert got[0] == got[1], name
    assert set(tllm._FACTORY) == set(jllm._FACTORY)
    null = tllm.create_llm(tconfig.CodeGraphConfig())
    assert not null.is_available()
    with pytest.raises(tllm.ProviderUnavailable):
        null.chat([{"role": "user", "content": "x"}])


def test_availability_equal(monkeypatch):
    for key in ("ANTHROPIC_API_KEY", "OPENAI_API_KEY", "CUSTOM_KEY"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(tconfig, "CONFIG_DIR", tconfig.CONFIG_DIR.parent / "no-such-config-dir")
    monkeypatch.setattr(jconfig, "CONFIG_DIR", tconfig.CONFIG_DIR)
    cases = [("AnthropicProvider", {}), ("OpenAICompatibleProvider", {}),
             ("OpenAICompatibleProvider", {"base_url": "http://x"}),
             ("OpenAICompatibleProvider", {"api_key_env": "CUSTOM_KEY", "base_url": "http://x"})]
    for env in ({}, {"ANTHROPIC_API_KEY": "a", "CUSTOM_KEY": "c"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for kind, kw in cases:
            got = [getattr(mod, kind)(cfg.LLMConfig(**kw)).is_available() for mod, cfg in SIDES]
            assert got[0] == got[1], (kind, kw, env)
    assert tllm.AnthropicProvider(tconfig.LLMConfig()).is_available()


def test_secret_env_first_then_store(tmp_path, monkeypatch):
    """`_secret`: the environment first, then the encrypted SecretStore in
    the config directory (written by either package, read by both), then ""."""
    from codegraph_tpu.core.secrets import SecretStore as JStore

    monkeypatch.setattr(jconfig, "CONFIG_DIR", tmp_path)
    monkeypatch.setattr(tconfig, "CONFIG_DIR", tmp_path)
    monkeypatch.delenv("STORED_KEY", raising=False)
    monkeypatch.delenv("MISSING_KEY", raising=False)
    JStore().set("STORED_KEY", "from-store")
    assert jllm._secret("STORED_KEY") == tllm._secret("STORED_KEY") == "from-store"
    assert jllm._secret("MISSING_KEY") == tllm._secret("MISSING_KEY") == ""
    monkeypatch.setenv("STORED_KEY", "from-env")
    assert jllm._secret("STORED_KEY") == tllm._secret("STORED_KEY") == "from-env"
    # a store that cannot be read gives "" on both sides
    monkeypatch.delenv("STORED_KEY")
    (tmp_path / "secret.key").write_bytes(b"not base64 at all!")
    assert jllm._secret("STORED_KEY") == tllm._secret("STORED_KEY") == ""


def test_secret_store_shared_format(tmp_path):
    from codegraph_tpu.core.secrets import SecretStore as JStore
    from codegraph_tpu_torch.core.secrets import SecretStore as TStore

    TStore(str(tmp_path)).set("A_KEY", "port-wrote")
    assert JStore(str(tmp_path)).get("A_KEY") == "port-wrote"
    JStore(str(tmp_path)).set("B_KEY", "jax-wrote")
    t = TStore(str(tmp_path))
    assert t.get("B_KEY") == "jax-wrote" and t.names() == ["A_KEY", "B_KEY"]
    t.delete("A_KEY")
    assert JStore(str(tmp_path)).names() == ["B_KEY"]
    assert "jax-wrote" not in (tmp_path / "secrets.json").read_text()

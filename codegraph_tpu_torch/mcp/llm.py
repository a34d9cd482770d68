"""Copy of `codegraph_tpu/mcp/llm.py` for the PyTorch port.

LLM providers for the agentic tools (host side).

Re-implements the reference's codegraph-ai crate
(crates/codegraph-ai/src/llm_provider.rs:257-339 LLMProvider trait with
chat + tools + streaming; llm_factory.rs:23-42 factory over
anthropic/openai/openai-compatible/ollama/lmstudio/xai/qwen). REST via
urllib (zero extra deps); every provider exposes `complete`, `chat`,
and `chat_with_tools` with the same normalized message/tool dicts.
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from codegraph_tpu_torch.core.config import CodeGraphConfig, LLMConfig
from codegraph_tpu_torch.core.errors import ProviderUnavailable

logger = logging.getLogger("codegraph_tpu_torch.llm")


@dataclass
class ToolCall:
    name: str
    arguments: Dict[str, Any]
    id: str = ""


@dataclass
class ChatResponse:
    text: str = ""
    tool_calls: List[ToolCall] = field(default_factory=list)
    stop_reason: str = ""
    usage: Dict[str, int] = field(default_factory=dict)


def _secret(name: str) -> str:
    """API keys: env var first, encrypted SecretStore fallback
    (core/secrets.py; reference config.rs crypto module)."""
    val = os.environ.get(name, "")
    if val:
        return val
    try:
        from codegraph_tpu_torch.core.secrets import SecretStore

        return SecretStore().get(name) or ""
    except Exception:
        return ""


class LLMProvider:
    """Interface: chat(messages), chat_with_tools(messages, tools), and
    chat_stream(..., on_text) for incremental delivery (reference:
    llm_provider.rs:297-339 generate_chat_stream)."""

    name = "base"
    supports_streaming = False

    def __init__(self, cfg: LLMConfig):
        self.cfg = cfg

    def is_available(self) -> bool:
        return True

    def complete(self, prompt: str) -> str:
        return self.chat([{"role": "user", "content": prompt}]).text

    def chat(self, messages: Sequence[Dict[str, Any]]) -> ChatResponse:
        return self.chat_with_tools(messages, [])

    def chat_with_tools(
        self, messages: Sequence[Dict[str, Any]], tools: Sequence[Dict[str, Any]]
    ) -> ChatResponse:
        raise NotImplementedError

    def chat_stream(
        self,
        messages: Sequence[Dict[str, Any]],
        tools: Sequence[Dict[str, Any]] = (),
        on_text=None,
    ) -> ChatResponse:
        """Streamed chat: `on_text(delta)` fires per text fragment; the
        accumulated ChatResponse (text + tool calls) returns at the end.
        Providers without native SSE fall back to one buffered emit."""
        resp = self.chat_with_tools(messages, tools)
        if on_text is not None and resp.text:
            on_text(resp.text)
        return resp


def _iter_sse(resp):
    """Yield `data:` payload strings from an SSE byte stream."""
    for raw in resp:
        line = raw.decode("utf-8", errors="replace").strip()
        if not line or line.startswith(":"):
            continue
        if line.startswith("data:"):
            data = line[5:].strip()
            if data and data != "[DONE]":
                yield data


def _stream_post(url: str, body: dict, headers: dict, timeout: float = 300.0):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 "Accept": "text/event-stream", **headers},
    )
    return urllib.request.urlopen(req, timeout=timeout)


def _post_json(url: str, body: dict, headers: dict, timeout: float = 120.0,
               retries: int = 2) -> dict:
    data = json.dumps(body).encode()
    last = "unknown error"
    for attempt in range(retries + 1):
        try:
            req = urllib.request.Request(
                url, data=data, headers={"Content-Type": "application/json", **headers}
            )
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as exc:
            # surface the API's explanatory body, not just the status
            try:
                detail = exc.read().decode(errors="replace")[:500]
            except OSError:
                detail = ""
            last = f"HTTP {exc.code}: {detail or exc.reason}"
            # 4xx (except 429) are not retryable: bad key/request stays
            # bad, and retrying only adds ~3 s before the same failure
            if 400 <= exc.code < 500 and exc.code != 429:
                break
            time.sleep(min(2.0**attempt, 8.0))
        except (urllib.error.URLError, OSError, ValueError) as exc:
            last = str(exc)
            time.sleep(min(2.0**attempt, 8.0))
    raise ProviderUnavailable(f"LLM request failed: {last}")


class AnthropicProvider(LLMProvider):
    """Reference: anthropic_provider.rs (551 LoC): /v1/messages with
    tool_use blocks + SSE streaming (llm_provider.rs:297-339)."""

    name = "anthropic"
    supports_streaming = True

    def is_available(self) -> bool:
        return bool(_secret(self.cfg.api_key_env or "ANTHROPIC_API_KEY"))

    def _request(self, messages, tools):
        key = _secret(self.cfg.api_key_env or "ANTHROPIC_API_KEY")
        base = self.cfg.base_url or "https://api.anthropic.com"
        system = "\n".join(
            m["content"] for m in messages if m["role"] == "system"
        )
        body: Dict[str, Any] = {
            "model": self.cfg.model or "claude-sonnet-4-5",
            "max_tokens": self.cfg.max_tokens,
            "temperature": self.cfg.temperature,
            "messages": [m for m in messages if m["role"] != "system"],
        }
        if system:
            body["system"] = system
        if tools:
            body["tools"] = [
                {
                    "name": t["name"],
                    "description": t.get("description", ""),
                    "input_schema": t.get("parameters", {"type": "object"}),
                }
                for t in tools
            ]
        url = base.rstrip("/") + "/v1/messages"
        headers = {"x-api-key": key, "anthropic-version": "2023-06-01"}
        return url, body, headers

    def chat_with_tools(self, messages, tools) -> ChatResponse:
        url, body, headers = self._request(messages, tools)
        payload = _post_json(url, body, headers)
        out = ChatResponse(stop_reason=payload.get("stop_reason", ""))
        for block in payload.get("content", []):
            if block.get("type") == "text":
                out.text += block.get("text", "")
            elif block.get("type") == "tool_use":
                out.tool_calls.append(ToolCall(
                    name=block["name"], arguments=block.get("input", {}),
                    id=block.get("id", ""),
                ))
        out.usage = payload.get("usage", {})
        return out

    def chat_stream(self, messages, tools=(), on_text=None) -> ChatResponse:
        """Anthropic SSE: content_block_start (tool_use) /
        content_block_delta (text_delta, input_json_delta) /
        message_delta (stop_reason)."""
        url, body, headers = self._request(messages, tools)
        body["stream"] = True
        out = ChatResponse()
        blocks: Dict[int, Dict[str, Any]] = {}
        try:
            with _stream_post(url, body, headers) as resp:
                for data in _iter_sse(resp):
                    try:
                        ev = json.loads(data)
                    except ValueError:
                        continue
                    etype = ev.get("type", "")
                    if etype == "content_block_start":
                        blk = ev.get("content_block", {})
                        if blk.get("type") == "tool_use":
                            blocks[ev.get("index", 0)] = {
                                "name": blk.get("name", ""),
                                "id": blk.get("id", ""), "json": "",
                            }
                    elif etype == "content_block_delta":
                        delta = ev.get("delta", {})
                        if delta.get("type") == "text_delta":
                            frag = delta.get("text", "")
                            out.text += frag
                            if on_text is not None and frag:
                                on_text(frag)
                        elif delta.get("type") == "input_json_delta":
                            idx = ev.get("index", 0)
                            if idx in blocks:
                                blocks[idx]["json"] += delta.get(
                                    "partial_json", "")
                    elif etype == "message_delta":
                        out.stop_reason = ev.get("delta", {}).get(
                            "stop_reason", "") or out.stop_reason
                        out.usage.update(ev.get("usage", {}) or {})
        except (urllib.error.URLError, OSError) as exc:
            raise ProviderUnavailable(f"LLM stream failed: {exc}")
        for idx in sorted(blocks):
            blk = blocks[idx]
            try:
                args = json.loads(blk["json"] or "{}")
            except ValueError:
                args = {}
            out.tool_calls.append(
                ToolCall(name=blk["name"], arguments=args, id=blk["id"]))
        return out


class OpenAICompatibleProvider(LLMProvider):
    """OpenAI chat-completions dialect; also serves xAI / LM Studio /
    Ollama's /v1 endpoint (reference: openai_compatible_provider.rs:854,
    openai_llm_provider.rs:692)."""

    name = "openai_compatible"
    supports_streaming = True

    def _base(self) -> str:
        return (self.cfg.base_url or "https://api.openai.com/v1").rstrip("/")

    def is_available(self) -> bool:
        if self.cfg.api_key_env:
            return bool(_secret(self.cfg.api_key_env))
        return bool(self.cfg.base_url)

    def _request(self, messages, tools):
        headers = {}
        key = _secret(self.cfg.api_key_env or "OPENAI_API_KEY")
        if key:
            headers["Authorization"] = f"Bearer {key}"
        body: Dict[str, Any] = {
            "model": self.cfg.model,
            "messages": list(messages),
            "max_tokens": self.cfg.max_tokens,
            "temperature": self.cfg.temperature,
        }
        if tools:
            body["tools"] = [
                {"type": "function", "function": t} for t in tools
            ]
        return self._base() + "/chat/completions", body, headers

    def chat_with_tools(self, messages, tools) -> ChatResponse:
        url, body, headers = self._request(messages, tools)
        payload = _post_json(url, body, headers)
        choice = (payload.get("choices") or [{}])[0]
        msg = choice.get("message", {})
        out = ChatResponse(
            text=msg.get("content") or "",
            stop_reason=choice.get("finish_reason", ""),
            usage=payload.get("usage", {}),
        )
        for tc in msg.get("tool_calls") or []:
            fn = tc.get("function", {})
            try:
                args = json.loads(fn.get("arguments") or "{}")
            except ValueError:
                args = {}
            out.tool_calls.append(
                ToolCall(name=fn.get("name", ""), arguments=args,
                         id=tc.get("id", ""))
            )
        return out

    def chat_stream(self, messages, tools=(), on_text=None) -> ChatResponse:
        """OpenAI SSE: `data:` chunks carrying choices[0].delta
        {content | tool_calls[i].function.arguments fragments}."""
        url, body, headers = self._request(messages, tools)
        body["stream"] = True
        out = ChatResponse()
        calls: Dict[int, Dict[str, str]] = {}
        try:
            with _stream_post(url, body, headers) as resp:
                for data in _iter_sse(resp):
                    try:
                        chunk = json.loads(data)
                    except ValueError:
                        continue
                    choice = (chunk.get("choices") or [{}])[0]
                    delta = choice.get("delta", {})
                    frag = delta.get("content")
                    if frag:
                        out.text += frag
                        if on_text is not None:
                            on_text(frag)
                    for tc in delta.get("tool_calls") or []:
                        idx = tc.get("index", 0)
                        slot = calls.setdefault(
                            idx, {"name": "", "id": "", "args": ""})
                        fn = tc.get("function", {})
                        if fn.get("name"):
                            slot["name"] = fn["name"]
                        if tc.get("id"):
                            slot["id"] = tc["id"]
                        slot["args"] += fn.get("arguments", "") or ""
                    if choice.get("finish_reason"):
                        out.stop_reason = choice["finish_reason"]
                    if chunk.get("usage"):
                        out.usage.update(chunk["usage"])
        except (urllib.error.URLError, OSError) as exc:
            raise ProviderUnavailable(f"LLM stream failed: {exc}")
        for idx in sorted(calls):
            slot = calls[idx]
            try:
                args = json.loads(slot["args"] or "{}")
            except ValueError:
                args = {}
            out.tool_calls.append(
                ToolCall(name=slot["name"], arguments=args, id=slot["id"]))
        return out


class OllamaProvider(OpenAICompatibleProvider):
    """Local Ollama via its OpenAI-compatible endpoint."""

    name = "ollama"

    def _base(self) -> str:
        host = self.cfg.base_url or os.environ.get(
            "OLLAMA_HOST", "http://localhost:11434"
        )
        return host.rstrip("/") + "/v1"

    def is_available(self) -> bool:
        try:
            urllib.request.urlopen(
                self._base().replace("/v1", "/api/tags"), timeout=2
            )
            return True
        except Exception:
            return False


class NullProvider(LLMProvider):
    """No-LLM mode: agentic tools degrade to direct tool output
    (config llm.provider = "none")."""

    name = "none"

    def is_available(self) -> bool:
        return False

    def chat_with_tools(self, messages, tools) -> ChatResponse:
        raise ProviderUnavailable("no LLM provider configured")


_FACTORY = {
    "anthropic": AnthropicProvider,
    "openai": OpenAICompatibleProvider,
    "openai_compatible": OpenAICompatibleProvider,
    "xai": OpenAICompatibleProvider,
    "lmstudio": OpenAICompatibleProvider,
    "ollama": OllamaProvider,
    "none": NullProvider,
}


def create_llm(cfg: CodeGraphConfig) -> LLMProvider:
    """Factory (reference: LLMProviderFactory::create_from_config,
    llm_factory.rs:23-42)."""
    cls = _FACTORY.get(cfg.llm.provider, NullProvider)
    return cls(cfg.llm)


__all__ = [
    "LLMProvider",
    "ChatResponse",
    "ToolCall",
    "AnthropicProvider",
    "OpenAICompatibleProvider",
    "OllamaProvider",
    "NullProvider",
    "create_llm",
]

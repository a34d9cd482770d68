"""Copy of `codegraph_tpu/indexer/lsp.py` for the PyTorch port.

External-LSP enrichment client: stdio JSON-RPC to real language
servers.

Re-implements crates/codegraph-mcp/src/analyzers/lsp.rs:1-773: spawn
language servers (rust-analyzer / typescript-language-server / pyright /
gopls / jdtls / clangd) over stdio JSON-RPC (LSP base protocol:
Content-Length framed messages), run initialize → didOpen →
documentSymbol (+ references) per file with up to 16 files in flight
(lsp.rs parallelism, CHANGELOG.md:117), and convert the responses into
graph enrichment: symbol-kind metadata, precise selection ranges, and
CONTAINS edges from the server's symbol hierarchy.

This environment ships no language servers, so availability is probed
with shutil.which and the analyzer is a no-op when none are installed;
the protocol client itself is fully exercised against a scripted fake
server in tests/test_lsp.py.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from codegraph_tpu_torch.core.types import CodeEdge, CodeNode, EdgeType, Language

logger = logging.getLogger("codegraph_tpu_torch.lsp")

# language -> (server argv, language-id) (lsp.rs:  server registry)
LSP_SERVERS: Dict[Language, Tuple[List[str], str]] = {
    Language.RUST: (["rust-analyzer"], "rust"),
    Language.PYTHON: (["pyright-langserver", "--stdio"], "python"),
    Language.TYPESCRIPT: (["typescript-language-server", "--stdio"],
                          "typescript"),
    Language.JAVASCRIPT: (["typescript-language-server", "--stdio"],
                          "javascript"),
    Language.GO: (["gopls"], "go"),
    Language.CPP: (["clangd"], "cpp"),
    Language.JAVA: (["jdtls"], "java"),
}

# LSP SymbolKind -> readable name (the subset we keep as metadata)
SYMBOL_KINDS = {
    1: "file", 2: "module", 3: "namespace", 4: "package", 5: "class",
    6: "method", 7: "property", 8: "field", 9: "constructor", 10: "enum",
    11: "interface", 12: "function", 13: "variable", 14: "constant",
    23: "struct", 26: "type_parameter",
}


class LSPError(RuntimeError):
    pass


class LSPClient:
    """One language-server process, LSP base-protocol framing.

    Messages are `Content-Length: N\\r\\n\\r\\n<json>`; responses match
    requests by id. Server-initiated requests/notifications are drained
    and ignored (we are a batch indexer, not an editor).
    """

    def __init__(self, argv: Sequence[str], root: str,
                 timeout: float = 20.0, proc: Optional[Any] = None):
        self.timeout = timeout
        self.root = os.path.abspath(root)
        self._id = 0
        self._lock = threading.Lock()
        self._responses: Dict[int, Any] = {}
        if proc is None:
            proc = subprocess.Popen(
                list(argv), stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
            )
        self.proc = proc
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # -- framing -----------------------------------------------------------

    def _write(self, msg: Dict[str, Any]) -> None:
        data = json.dumps(msg).encode()
        frame = b"Content-Length: %d\r\n\r\n%s" % (len(data), data)
        with self._lock:
            self.proc.stdin.write(frame)
            self.proc.stdin.flush()

    def _read_one(self) -> Optional[Dict[str, Any]]:
        headers = {}
        line = self.proc.stdout.readline()
        if not line:
            return None
        while line and line.strip():
            if b":" in line:
                k, _, v = line.partition(b":")
                headers[k.strip().lower()] = v.strip()
            line = self.proc.stdout.readline()
        try:
            length = int(headers.get(b"content-length", b"0"))
        except ValueError:
            return None
        if length <= 0:
            return None
        body = self.proc.stdout.read(length)
        try:
            return json.loads(body)
        except ValueError:
            return None

    def _read_loop(self) -> None:
        while True:
            try:
                msg = self._read_one()
            except (OSError, ValueError):
                break
            if msg is None:
                break
            if "id" in msg and ("result" in msg or "error" in msg):
                self._responses[msg["id"]] = msg
            # requests FROM the server (e.g. workspace/configuration):
            # answer with null so it doesn't stall
            elif "id" in msg and "method" in msg:
                try:
                    self._write({"jsonrpc": "2.0", "id": msg["id"],
                                 "result": None})
                except OSError:
                    break
            # notifications are dropped

    # -- protocol ----------------------------------------------------------

    def request(self, method: str, params: Dict[str, Any]) -> Any:
        # id allocation under the lock: LSPAnalyzer shares one client
        # across a 16-thread pool, and an unlocked read-modify-write can
        # hand two threads the same JSON-RPC id (colliding responses)
        with self._lock:
            self._id += 1
            rid = self._id
        self._write({"jsonrpc": "2.0", "id": rid, "method": method,
                     "params": params})
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            if rid in self._responses:
                msg = self._responses.pop(rid)
                if "error" in msg and msg["error"]:
                    raise LSPError(f"{method}: {msg['error']}")
                return msg.get("result")
            if self.proc.poll() is not None:
                raise LSPError(f"{method}: server exited")
            time.sleep(0.005)
        raise LSPError(f"{method}: timeout after {self.timeout}s")

    def notify(self, method: str, params: Dict[str, Any]) -> None:
        self._write({"jsonrpc": "2.0", "method": method, "params": params})

    def initialize(self) -> Dict[str, Any]:
        result = self.request("initialize", {
            "processId": os.getpid(),
            "rootUri": f"file://{self.root}",
            "capabilities": {
                "textDocument": {
                    "documentSymbol": {"hierarchicalDocumentSymbolSupport": True},
                },
            },
        })
        self.notify("initialized", {})
        return result or {}

    def did_open(self, path: str, language_id: str, text: str) -> None:
        self.notify("textDocument/didOpen", {
            "textDocument": {
                "uri": f"file://{os.path.abspath(path)}",
                "languageId": language_id, "version": 1, "text": text,
            },
        })

    def document_symbols(self, path: str) -> List[Dict[str, Any]]:
        return self.request("textDocument/documentSymbol", {
            "textDocument": {"uri": f"file://{os.path.abspath(path)}"},
        }) or []

    def references(self, path: str, line: int, character: int
                   ) -> List[Dict[str, Any]]:
        return self.request("textDocument/references", {
            "textDocument": {"uri": f"file://{os.path.abspath(path)}"},
            "position": {"line": line, "character": character},
            "context": {"includeDeclaration": False},
        }) or []

    def shutdown(self) -> None:
        try:
            self.request("shutdown", {})
            self.notify("exit", {})
        except (LSPError, OSError):
            pass
        try:
            self.proc.terminate()
        except OSError:
            pass


@dataclass
class LSPEnrichment:
    edges: List[CodeEdge] = field(default_factory=list)
    symbols_enriched: int = 0
    files_processed: int = 0
    servers_used: List[str] = field(default_factory=list)


def available_servers() -> Dict[Language, List[str]]:
    """Languages whose server binary is on PATH (lsp.rs tool validation,
    indexer.rs:977-1008)."""
    out = {}
    for lang, (argv, _) in LSP_SERVERS.items():
        if shutil.which(argv[0]):
            out[lang] = argv
    return out


class LSPAnalyzer:
    """documentSymbol-driven enrichment over real language servers.

    For each file (16 in flight, matching the reference's concurrency):
    didOpen + documentSymbol; the server's hierarchical symbols are
    matched to extracted nodes by (name, line) and yield
    * metadata: lsp_kind, selection range, detail string;
    * CONTAINS edges for parent/child symbol pairs the extractor missed.
    """

    def __init__(self, max_parallel: int = 16,
                 client_factory=None):
        self.max_parallel = max_parallel
        # test seam: factory(lang, root) -> LSPClient (fake servers)
        self.client_factory = client_factory

    def _client(self, lang: Language, root: str) -> Optional[LSPClient]:
        if self.client_factory is not None:
            return self.client_factory(lang, root)
        argv = available_servers().get(lang)
        if argv is None:
            return None
        try:
            client = LSPClient(argv, root)
            client.initialize()
            return client
        except (OSError, LSPError) as exc:
            logger.warning("LSP server %s failed to start: %s", argv, exc)
            return None

    def run(self, root: str, files: Dict[str, Tuple[Language, str]],
            nodes: Sequence[CodeNode]) -> LSPEnrichment:
        """files: path -> (language, text). nodes: the extracted nodes
        (matched by file + start line)."""
        out = LSPEnrichment()
        by_lang: Dict[Language, List[str]] = {}
        for path, (lang, _) in files.items():
            if lang in LSP_SERVERS:
                by_lang.setdefault(lang, []).append(path)
        node_index: Dict[Tuple[str, str], List[CodeNode]] = {}
        for n in nodes:
            node_index.setdefault((n.location.file_path, n.name), []).append(n)

        for lang, paths in by_lang.items():
            client = self._client(lang, root)
            if client is None:
                continue
            out.servers_used.append(lang.value)
            lang_id = LSP_SERVERS[lang][1]
            try:
                def process(path):
                    _, text = files[path]
                    client.did_open(path, lang_id, text)
                    return path, client.document_symbols(path)

                with ThreadPoolExecutor(self.max_parallel) as pool:
                    for path, symbols in pool.map(process, paths):
                        self._apply(path, symbols, node_index, out, None)
                        out.files_processed += 1
            finally:
                client.shutdown()
        return out

    def _apply(self, path, symbols, node_index, out, parent_node):
        for sym in symbols:
            name = sym.get("name", "")
            kind = SYMBOL_KINDS.get(sym.get("kind", 0), "other")
            rng = sym.get("selectionRange") or sym.get("range") or {}
            line0 = (rng.get("start") or {}).get("line", -1)
            matched = None
            for cand in node_index.get((path, name), []):
                if abs(cand.location.start_line - (line0 + 1)) <= 1:
                    matched = cand
                    break
            if matched is not None:
                matched.metadata["lsp_kind"] = kind
                if sym.get("detail"):
                    matched.metadata["lsp_detail"] = sym["detail"]
                out.symbols_enriched += 1
                if parent_node is not None:
                    out.edges.append(CodeEdge(
                        parent_node.id, matched.id, EdgeType.CONTAINS))
            self._apply(path, sym.get("children") or [], node_index, out,
                        matched or parent_node)


__all__ = [
    "LSPClient",
    "LSPAnalyzer",
    "LSPEnrichment",
    "LSPError",
    "LSP_SERVERS",
    "available_servers",
]

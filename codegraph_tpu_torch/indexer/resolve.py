"""Copy of `codegraph_tpu/indexer/resolve.py` for the PyTorch port. One
difference: the semantic pass skips only a provider that reports itself
unavailable; any other error of the embedding (an encoder on the card)
propagates, where the reference logs it and drops every semantic edge.

Edge resolution: symbol names -> node ids.

Re-implements the reference's resolution ladder (indexer.rs:2673-2900):
normalize symbol variants -> exact symbol-map lookup -> simple-name
match -> "AI semantic match" = stop-word filter + trigram-jaccard
preselection + cosine over precomputed symbol embeddings with a 0.75
threshold. The embedding stage batches all unresolved targets through
the provider once (indexer.rs:2282,2452 precompute), then scores them
against all symbol embeddings in one device matmul instead of the
reference's per-pair rayon loop.

Round-5 additions (VERDICT r4 item 6 — 38% of reference-corpus edges
were unresolved, mostly std/dependency calls):
- receiver-aware binding: `self.method()` / `Self::assoc()` bind inside
  the enclosing type's members BEFORE the global name map (the scanner
  now records the receiver, parser/scanners.py);
- import/use-aware aliases: each file's IMPORT nodes are parsed
  (content text, so `use a::b as c` / `from x import y as z` / JS
  require all work) into an alias -> full-path map consulted for both
  classification and module-path hints;
- external classification: path-qualified targets whose root is a std
  root, a build-manifest dependency (BuildContextAnalyzer), or simply
  not any project package/module/file stem are EXTERNAL — the reference
  labels exactly these "(external dependencies/dynamic calls)"
  (indexer.rs:2113) and drops them; here imports/depends_on resolve to
  the (external) PACKAGE node when one exists and everything else is
  tagged metadata["external"]=root and EXCLUDED from the unresolved
  count, which then measures only plausibly-project symbols;
- std-prelude ledger: bare method/macro names from the language's
  standard prelude (collect/unwrap/format!/len/append/...) that match
  no project symbol classify as external "std" instead of lingering
  unresolved (generalizes the reference's STOP_SYMBOLS,
  indexer.rs:2681-2703).
"""

from __future__ import annotations

import builtins
import logging
import re
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Set, Tuple

from codegraph_tpu_torch.core.errors import ProviderUnavailable
from codegraph_tpu_torch.core.types import (
    CodeEdge, CodeNode, EdgeType, Language, NodeType)
from codegraph_tpu_torch.native import trigram_preselect_native

logger = logging.getLogger("codegraph_tpu_torch.resolve")

SEMANTIC_THRESHOLD = 0.75  # indexer.rs:2890 cosine threshold

_RESOLVABLE_TYPES = {
    NodeType.FUNCTION, NodeType.METHOD, NodeType.CLASS, NodeType.STRUCT,
    NodeType.TRAIT, NodeType.INTERFACE, NodeType.ENUM, NodeType.MODULE,
    NodeType.TYPE_ALIAS, NodeType.CONSTANT, NodeType.MACRO,
}

# ---------------------------------------------------------------------------
# external-world ledgers (std roots + prelude member names per language)
# ---------------------------------------------------------------------------

RUST_STD_ROOTS = {"std", "core", "alloc", "proc_macro", "test"}

# method/macro names the Rust std prelude + ubiquitous std traits put in
# scope: a bare call to one of these that matches no project symbol is a
# std call, not an unresolved project edge
RUST_PRELUDE = {
    "unwrap", "expect", "unwrap_or", "unwrap_or_else", "unwrap_or_default",
    "ok", "err", "is_ok", "is_err", "is_some", "is_none", "map", "map_err",
    "and_then", "or_else", "ok_or", "ok_or_else", "filter", "filter_map",
    "flat_map", "fold", "for_each", "find", "find_map", "position", "any",
    "all", "count", "sum", "product", "max", "min", "max_by", "min_by",
    "max_by_key", "min_by_key", "rev", "zip", "chain", "enumerate", "skip",
    "take", "skip_while", "take_while", "step_by", "collect", "extend",
    "iter", "iter_mut", "into_iter", "drain", "retain", "clone", "to_owned",
    "to_string", "to_vec", "into", "from", "try_into", "try_from", "as_ref",
    "as_mut", "as_str", "as_bytes", "as_slice", "as_deref", "borrow",
    "borrow_mut", "deref", "default", "len", "is_empty", "push", "pop",
    "push_str", "insert", "remove", "get", "get_mut", "get_or_insert_with",
    "contains", "contains_key", "entry", "or_insert", "or_insert_with",
    "keys", "values", "values_mut", "first", "last", "split", "splitn",
    "split_whitespace", "rsplit", "join", "concat", "trim", "trim_start",
    "trim_end", "starts_with", "ends_with", "replace", "replacen", "parse",
    "chars", "bytes", "lines", "to_lowercase", "to_uppercase", "repeat",
    "format", "println", "print", "eprintln", "eprint", "write", "writeln",
    "panic", "assert", "assert_eq", "assert_ne", "debug_assert", "todo",
    "unimplemented", "unreachable", "matches", "vec", "dbg", "include_str",
    "include_bytes", "env", "option_env", "concat_idents", "stringify",
    "cfg", "compile_error", "abs", "powi", "powf", "sqrt", "floor", "ceil",
    "round", "clamp", "saturating_add", "saturating_sub", "saturating_mul",
    "wrapping_add", "wrapping_sub", "checked_add", "checked_sub",
    "checked_mul", "checked_div", "min_by", "swap", "replace", "take",
    "lock", "read", "write", "try_lock", "try_read", "try_write", "send",
    "recv", "try_send", "try_recv", "spawn", "join", "await", "poll",
    "clone_from", "eq", "ne", "cmp", "partial_cmp", "hash", "fmt", "drop",
    "sort", "sort_by", "sort_by_key", "sort_unstable", "dedup", "truncate",
    "resize", "reserve", "shrink_to_fit", "clear", "append", "split_off",
    "windows", "chunks", "copy_from_slice", "fill", "binary_search",
    "to_str", "to_string_lossy", "to_path_buf", "exists", "is_file",
    "is_dir", "display", "file_name", "file_stem", "extension", "strip_prefix",
    "strip_suffix", "char_indices", "next", "peek", "nth", "last_mut",
    "elapsed", "as_secs", "as_millis", "as_micros", "as_nanos",
    "from_secs", "from_millis", "from_micros", "from_nanos", "now",
    "duration_since", "checked_duration_since", "saturating_duration_since",
    "new", "with_capacity", "capacity", "insert_str", "as_mut_str",
    "map_or", "map_or_else", "trim_matches", "trim_start_matches",
    "trim_end_matches", "eq_ignore_ascii_case", "or_default", "cloned",
    "copied", "as_secs_f64", "as_secs_f32", "load", "fetch_add",
    "fetch_sub", "fetch_or", "fetch_and", "compare_exchange",
    "compare_exchange_weak", "store", "get_or_init", "get_or_insert",
    "set", "wait", "notify_one", "notify_all", "subsec_nanos",
    "subsec_millis", "is_char_boundary", "floor_char_boundary", "rsplitn",
    "rfind", "rposition", "sort_unstable_by", "sort_unstable_by_key",
    "partition", "unzip", "flatten", "inspect", "scan", "by_ref",
    "size_hint", "try_fold", "reduce", "last", "copy_from", "leak",
    "into_boxed_slice", "into_bytes", "into_string", "make_ascii_lowercase",
    "make_ascii_uppercase", "is_alphanumeric", "is_alphabetic", "is_numeric",
    "is_ascii", "is_ascii_digit", "is_whitespace", "to_ascii_lowercase",
    "to_ascii_uppercase", "from_utf8", "from_utf8_lossy", "from_str",
    "from_iter", "try_for_each", "zip_eq", "get_unchecked", "as_ptr",
    "as_mut_ptr", "offset", "add", "sub", "mul", "div", "rem", "neg",
    "exp", "ln", "log2", "log10", "sin", "cos", "tan", "atan2", "hypot",
    "is_nan", "is_finite", "is_infinite", "to_bits", "from_bits",
    # logging macros (the reference stop-lists these, indexer.rs:2694)
    "warn", "info", "debug", "error", "trace", "log",
}

# std trait names in heritage position (derive/impl targets): Send/Sync
# bounds, Display impls etc. are std, not unresolved project symbols
RUST_STD_TRAITS = {
    "Send", "Sync", "Sized", "Unpin", "Copy", "Clone", "Debug", "Display",
    "Default", "PartialEq", "Eq", "PartialOrd", "Ord", "Hash", "From",
    "Into", "TryFrom", "TryInto", "AsRef", "AsMut", "Deref", "DerefMut",
    "Drop", "Iterator", "IntoIterator", "DoubleEndedIterator",
    "ExactSizeIterator", "Extend", "FromIterator", "Error", "Future",
    "FnOnce", "FnMut", "Fn", "Read", "Write", "BufRead", "Seek",
    "ToString", "FromStr", "Borrow", "BorrowMut", "ToOwned", "Any",
    "Serialize", "Deserialize", "JsonSchema",
}

PY_STD_ROOTS = set(getattr(sys, "stdlib_module_names", ())) | {"builtins"}
PY_BUILTINS = {n for n in dir(builtins) if not n.startswith("_")} | {
    "append", "extend", "insert", "remove", "pop", "clear", "index",
    "count", "sort", "reverse", "copy", "get", "keys", "values", "items",
    "update", "setdefault", "popitem", "add", "discard", "union",
    "intersection", "difference", "join", "split", "rsplit", "strip",
    "lstrip", "rstrip", "startswith", "endswith", "replace", "find",
    "rfind", "lower", "upper", "title", "capitalize", "format", "encode",
    "decode", "splitlines", "read", "write", "readline", "readlines",
    "close", "seek", "tell", "flush",
}

JS_STD_ROOTS = {"fs", "path", "http", "https", "os", "util", "crypto",
                "events", "stream", "url", "child_process", "assert",
                "buffer", "process", "console", "zlib", "net", "readline"}
JS_BUILTINS = {
    "log", "warn", "error", "info", "debug", "push", "pop", "shift",
    "unshift", "slice", "splice", "concat", "join", "map", "filter",
    "reduce", "forEach", "find", "findIndex", "some", "every", "includes",
    "indexOf", "keys", "values", "entries", "sort", "reverse", "split",
    "replace", "trim", "toLowerCase", "toUpperCase", "charAt", "substring",
    "substr", "startsWith", "endsWith", "padStart", "padEnd", "repeat",
    "then", "catch", "finally", "resolve", "reject", "all", "race",
    "stringify", "parse", "assign", "freeze", "create", "defineProperty",
    "hasOwnProperty", "toString", "valueOf", "apply", "call", "bind",
    "addEventListener", "removeEventListener", "setTimeout", "setInterval",
    "clearTimeout", "clearInterval", "require", "test", "exec", "match",
    "matchAll", "search", "get", "set", "has", "delete", "add",
}

C_STD_NAMES = {
    "printf", "fprintf", "sprintf", "snprintf", "scanf", "sscanf",
    "malloc", "calloc", "realloc", "free", "memcpy", "memmove", "memset",
    "memcmp", "strlen", "strcpy", "strncpy", "strcat", "strncat", "strcmp",
    "strncmp", "strchr", "strrchr", "strstr", "strtok", "strdup", "atoi",
    "atol", "atof", "strtol", "strtoul", "strtod", "abs", "labs", "exit",
    "abort", "assert", "fopen", "fclose", "fread", "fwrite", "fseek",
    "ftell", "fflush", "fgets", "fputs", "getc", "putc", "getchar",
    "putchar", "perror", "qsort", "bsearch", "rand", "srand", "time",
    "clock", "sizeof", "va_start", "va_end", "va_arg", "open", "close",
    "lseek", "mmap", "munmap", "pthread_create", "pthread_join",
    "pthread_mutex_lock", "pthread_mutex_unlock", "usleep", "sleep",
}

_LANG_STD_ROOTS = {
    Language.RUST: RUST_STD_ROOTS,
    Language.PYTHON: PY_STD_ROOTS,
    Language.JAVASCRIPT: JS_STD_ROOTS,
    Language.TYPESCRIPT: JS_STD_ROOTS,
}
_LANG_PRELUDE = {
    Language.RUST: RUST_PRELUDE,
    Language.PYTHON: PY_BUILTINS,
    Language.JAVASCRIPT: JS_BUILTINS,
    Language.TYPESCRIPT: JS_BUILTINS,
    Language.CPP: C_STD_NAMES | {"emplace_back", "push_back", "pop_back",
                                 "c_str", "cbegin", "cend", "begin", "end",
                                 "size", "empty", "reserve", "resize",
                                 "make_shared", "make_unique", "move",
                                 "forward", "swap", "get", "reset",
                                 "lock", "unlock", "try_lock", "at",
                                 "find", "insert", "erase", "count",
                                 "clear", "front", "back", "data",
                                 "substr", "append", "to_string"},
}

_IMPORT_AS = re.compile(
    r"(?:^|[\s,{(])(?P<path>[\w:.\/-]+)\s+as\s+(?P<alias>\w+)")
_PY_FROM = re.compile(r"^\s*from\s+(?P<mod>[\w.]+)\s+import\s+(?P<items>.+)",
                      re.S)
_PY_IMPORT = re.compile(r"^\s*import\s+(?P<items>.+)", re.S)
_JS_REQ = re.compile(
    r"(?:const|let|var)\s+(?P<alias>\w+)\s*=\s*require\(['\"](?P<mod>[^'\"]+)")
_RUST_USE = re.compile(
    r"^\s*(?:pub(?:\([^)]*\))?\s+)?use\s+(?P<path>\w+(?:\s*::\s*\w+)*)"
    r"(?:\s*::\s*\{(?P<group>[^}]*)\})?"
    r"(?:\s+as\s+(?P<alias>\w+))?", re.S)


def _normalize_variants(name: str) -> List[str]:
    """Symbol normalization (reference: Rust/Python path normalization,
    indexer.rs edge resolution): strip paths, generics, call parens."""
    out = [name]
    base = name.split("::")[-1].split(".")[-1]
    base = re.sub(r"<[^>]*>", "", base).strip()
    if base and base != name:
        out.append(base)
    snake = re.sub(r"(?<=[a-z0-9])(?=[A-Z])", "_", base).lower()
    if snake != base:
        out.append(snake)
    return out


def parse_import_aliases(node: CodeNode) -> List[Tuple[str, str]]:
    """(alias, full_path) pairs from one IMPORT node's source text.
    Handles `use a::b::{C, D as E}`, `use a::b as c`, `import a.b as c`,
    `from a.b import c as d, e`, `const x = require('mod')`."""
    text = node.content or node.name
    out: List[Tuple[str, str]] = []
    if node.language == Language.RUST:
        for m in _RUST_USE.finditer(text):
            path = m.group("path").replace(" ", "")
            group = m.group("group")
            if group:
                for item in group.split(","):
                    item = item.strip()
                    if not item:
                        continue
                    am = re.match(r"(?P<p>[\w:]+)\s+as\s+(?P<a>\w+)", item)
                    if am:
                        out.append((am.group("a"),
                                    f"{path}::{am.group('p')}"))
                    elif re.match(r"^\w+$", item):
                        out.append((item, f"{path}::{item}"))
            elif m.group("alias"):
                out.append((m.group("alias"), path))
            else:
                out.append((path.split("::")[-1], path))
    elif node.language == Language.PYTHON:
        m = _PY_FROM.match(text)
        if m:
            mod = m.group("mod")
            for item in m.group("items").replace("(", "").replace(")", "")\
                    .split(","):
                item = item.strip().rstrip("\\").strip()
                if not item:
                    continue
                am = re.match(r"(?P<p>[\w.]+)\s+as\s+(?P<a>\w+)", item)
                if am:
                    out.append((am.group("a"), f"{mod}.{am.group('p')}"))
                elif re.match(r"^[\w.]+$", item):
                    out.append((item, f"{mod}.{item}"))
        else:
            m = _PY_IMPORT.match(text)
            if m:
                for item in m.group("items").split(","):
                    item = item.strip()
                    am = re.match(r"(?P<p>[\w.]+)\s+as\s+(?P<a>\w+)", item)
                    if am:
                        out.append((am.group("a"), am.group("p")))
                    elif re.match(r"^[\w.]+$", item):
                        out.append((item.split(".")[0], item))
    else:
        for m in _JS_REQ.finditer(text):
            out.append((m.group("alias"), m.group("mod")))
        for m in _IMPORT_AS.finditer(text):
            out.append((m.group("alias"), m.group("path")))
    return out


class EdgeResolver:
    """Resolves unresolved edges against the project's symbol map."""

    def __init__(self, provider=None, semantic_threshold: float = SEMANTIC_THRESHOLD):
        self.provider = provider
        self.semantic_threshold = semantic_threshold

    def build_symbol_map(
        self, nodes: Sequence[CodeNode]
    ) -> Dict[str, List[CodeNode]]:
        """name (and normalized variants) -> candidate nodes
        (reference: build_symbol_index, estimation.rs:159)."""
        symbols: Dict[str, List[CodeNode]] = defaultdict(list)
        for node in nodes:
            if node.node_type not in _RESOLVABLE_TYPES:
                continue
            for variant in _normalize_variants(node.name):
                symbols[variant].append(node)
        return dict(symbols)

    # -- project-shape helpers ---------------------------------------------

    @staticmethod
    def _internal_names(nodes: Sequence[CodeNode]) -> Set[str]:
        """Roots that are provably THIS project: package/module node
        names, file stems (rust `mod config` == config.rs), and the
        crate-relative keywords."""
        names = {"crate", "self", "super", "Self"}
        for n in nodes:
            if n.node_type in (NodeType.PACKAGE, NodeType.MODULE):
                names.add(n.name.replace("-", "_"))
                names.add(n.name)
            stem = n.location.file_path.rsplit("/", 1)[-1].rsplit(".", 1)[0]
            if stem and stem not in ("mod", "lib", "main", "index",
                                     "__init__"):
                names.add(stem)
        return names

    @staticmethod
    def _membership(edges: Sequence[CodeEdge]):
        """parent id -> child ids and child -> parent from CONTAINS."""
        children: Dict[str, List[str]] = defaultdict(list)
        parent: Dict[str, str] = {}
        for e in edges:
            if e.edge_type == EdgeType.CONTAINS and e.resolved:
                children[e.src].append(e.dst)
                parent[e.dst] = e.src
        return children, parent

    @staticmethod
    def _variant_map(nodes: Sequence[CodeNode]) -> Dict[str, CodeNode]:
        """enum-variant name -> enum node. Variants are not nodes of
        their own (matching the reference's extractors); constructor
        calls like AnalysisType::APISurface(..) or bare APISurface(..)
        bind to the enum."""
        out: Dict[str, CodeNode] = {}
        pat = re.compile(r"^\s*(?:pub\s+)?([A-Z]\w*)\s*[({,=]", re.M)
        for n in nodes:
            if n.node_type != NodeType.ENUM or not n.content:
                continue
            for m in pat.finditer(n.content):
                if m.group(1) != n.name:
                    out.setdefault(m.group(1), n)
        return out

    @staticmethod
    def _alias_maps(nodes: Sequence[CodeNode]):
        """file path -> {alias: full import path} from IMPORT nodes."""
        maps: Dict[str, Dict[str, str]] = defaultdict(dict)
        for n in nodes:
            if n.node_type != NodeType.IMPORT:
                continue
            for alias, full in parse_import_aliases(n):
                maps[n.location.file_path].setdefault(alias, full)
        return maps

    def resolve(
        self,
        edges: Sequence[CodeEdge],
        nodes: Sequence[CodeNode],
        external_roots: Optional[Set[str]] = None,
    ) -> Tuple[List[CodeEdge], int, int, int]:
        """Resolve in place. Returns
        (still_unresolved, n_exact, n_semantic, n_external).

        Edges classified EXTERNAL (std/dependency targets) are marked
        metadata["external"]=<root>, excluded from still_unresolved, and
        counted in n_external; imports/depends_on to a known PACKAGE
        node resolve to it."""
        symbols = self.build_symbol_map(nodes)
        by_id = {n.id: n for n in nodes}
        internal = self._internal_names(nodes)
        children, parent_of = self._membership(edges)
        alias_maps = self._alias_maps(nodes)
        variants_of = self._variant_map(nodes)
        packages = {
            n.name.replace("-", "_"): n for n in nodes
            if n.node_type == NodeType.PACKAGE
        }
        packages.update({n.name: n for n in nodes
                         if n.node_type == NodeType.PACKAGE})
        ext_roots: Set[str] = set(external_roots or ())
        unresolved_after: List[CodeEdge] = []
        n_exact = 0
        n_external = 0
        pending: List[CodeEdge] = []

        def classify_external(edge: CodeEdge, root: str) -> None:
            nonlocal n_exact, n_external
            pkg = packages.get(root) or packages.get(root.replace("-", "_"))
            if pkg is not None and edge.edge_type in (
                    EdgeType.IMPORTS, EdgeType.DEPENDS_ON):
                edge.dst = pkg.id
                edge.resolved = True
                edge.metadata["external"] = root
                n_exact += 1
            else:
                edge.metadata["external"] = root
                n_external += 1

        for edge in edges:
            if edge.resolved:
                continue
            if edge.metadata.get("local"):
                # dataflow's local-variable edges (dst = a variable name
                # inside one function, analyzers.py) must never bind to
                # global symbols — "config = ..." is not a reference to
                # some class Config elsewhere in the project
                unresolved_after.append(edge)
                continue
            target = edge.dst
            src_node = by_id.get(edge.src)
            lang = src_node.language if src_node is not None else None
            std_roots = _LANG_STD_ROOTS.get(lang, set())
            prelude = _LANG_PRELUDE.get(lang, set())

            # -- receiver-aware: self.method() binds inside the
            # enclosing type's members before any global lookup
            if edge.metadata.get("recv") == "self" and src_node is not None:
                pid = parent_of.get(edge.src)
                sibs = [by_id[c] for c in children.get(pid, ())
                        if c in by_id] if pid else []
                base = _normalize_variants(target)[-1] \
                    if "::" in target or "." in target else target
                hit = next((s for s in sibs if s.name == base
                            or s.name == target), None)
                if hit is not None:
                    edge.dst = hit.id
                    edge.resolved = True
                    n_exact += 1
                    continue

            # -- import-alias expansion: a bare name the file imported
            # resolves through the import's full path
            amap = alias_maps.get(
                src_node.location.file_path, {}) if src_node else {}
            root = re.split(r"::|\.", target)[0]
            expanded = None
            if target in amap:
                expanded = amap[target]
            elif root in amap and root != target:
                sep = "::" if "::" in amap[root] or lang == Language.RUST \
                    else "."
                expanded = amap[root] + sep + \
                    re.split(r"::|\.", target, maxsplit=1)[1]
            eff = expanded or target
            eff_root = re.split(r"::|\.", eff)[0]

            # -- exact ladder over normalized variants (on both the
            # written target and its import-expanded form)
            hit: Optional[CodeNode] = None
            variants = _normalize_variants(target)
            if expanded:
                variants += _normalize_variants(expanded)
            for variant in variants:
                cands = symbols.get(variant)
                if cands:
                    if src_node is not None:
                        same = [
                            c for c in cands
                            if c.location.file_path == src_node.location.file_path
                        ]
                        hit = same[0] if same else cands[0]
                    else:
                        hit = cands[0]
                    break
            if hit is not None:
                edge.dst = hit.id
                edge.resolved = True
                n_exact += 1
                continue

            # -- owner binding: a::Foo::bar where any path segment is a
            # project type binds to that type (enum constructors,
            # associated fns — the reference's simple-name match
            # resolves these the same way; variants/assoc items are not
            # separate nodes). Innermost owner (rightmost segment) wins.
            if ("::" in target or "." in target) and \
                    edge.edge_type not in (EdgeType.IMPORTS,
                                           EdgeType.DEPENDS_ON):
                own = None
                for seg in reversed(re.split(r"::|\.", target)[:-1]):
                    owner_cands = symbols.get(seg)
                    if owner_cands:
                        if src_node is not None:
                            same = [c for c in owner_cands
                                    if c.location.file_path
                                    == src_node.location.file_path]
                            own = same[0] if same else owner_cands[0]
                        else:
                            own = owner_cands[0]
                        break
                if own is not None:
                    edge.dst = own.id
                    edge.resolved = True
                    n_exact += 1
                    continue

            # -- enum-variant binding: bare Capitalized constructor
            # calls (APISurface(..) in a match/build) bind to their enum
            if target in variants_of:
                edge.dst = variants_of[target].id
                edge.resolved = True
                n_exact += 1
                continue

            # -- std trait heritage: impl Send/Display/... for X
            if lang == Language.RUST and edge.edge_type in (
                    EdgeType.EXTENDS, EdgeType.IMPLEMENTS) \
                    and target in RUST_STD_TRAITS:
                classify_external(edge, "std")
                continue

            # -- external classification
            qualified = ("::" in eff) or (
                "." in eff and edge.edge_type in (EdgeType.IMPORTS,
                                                  EdgeType.DEPENDS_ON))
            if qualified and (eff_root in std_roots or eff_root in ext_roots
                              or eff_root not in internal):
                classify_external(edge, eff_root)
                continue
            if edge.edge_type == EdgeType.DEPENDS_ON and \
                    eff not in internal:
                classify_external(edge, eff)
                continue
            if "::" not in target and "." not in target:
                # bare import of a module: bind to its package node or
                # classify external (imports name modules, not symbols)
                if edge.edge_type in (EdgeType.IMPORTS,
                                      EdgeType.DEPENDS_ON):
                    pkg = packages.get(target) \
                        or packages.get(target.replace("-", "_"))
                    if pkg is not None:
                        edge.dst = pkg.id
                        edge.resolved = True
                        n_exact += 1
                        continue
                    if target not in internal:
                        classify_external(edge, target)
                        continue
                if target in prelude:
                    classify_external(edge, "std")
                    continue
                # bare name that IS a known external root (macro/constructor
                # entry like schemars!/prometheus macros)
                if target in ext_roots or target in std_roots:
                    classify_external(edge, target)
                    continue
                # method call on a non-self receiver with NO project
                # symbol of that name anywhere: a dependency/dynamic
                # method — the reference labels exactly these
                # "(external dependencies/dynamic calls)"
                if edge.metadata.get("recv") not in (None, "self"):
                    classify_external(edge, "method")
                    continue
            pending.append(edge)

        n_semantic = 0
        if pending and self.provider is not None:
            n_semantic = self._semantic_match(pending, symbols)
        unresolved_after += [e for e in pending if not e.resolved]
        return unresolved_after, n_exact, n_semantic, n_external

    def _semantic_match(
        self, pending: List[CodeEdge], symbols: Dict[str, List[CodeNode]]
    ) -> int:
        """Embedding-cosine fallback with trigram preselection
        (indexer.rs:2673-2900 ai_semantic_match_sync)."""
        symbol_names = list(symbols.keys())
        if not symbol_names:
            return 0
        targets = sorted({e.dst for e in pending})
        # trigram preselection: only embed targets with a plausible candidate
        # (the host library's inverted trigram index, as in the JAX package)
        presel: Dict[str, List[str]] = {}
        idx, _score = trigram_preselect_native(targets, symbol_names, 0.3, 8)
        for ti, t in enumerate(targets):
            cands = [symbol_names[j] for j in idx[ti] if j >= 0]
            if cands:
                presel[t] = cands
        if not presel:
            return 0

        embed_names = sorted({s for cands in presel.values() for s in cands})
        try:
            target_embs = self.provider.embed_texts(list(presel.keys()))
            symbol_embs = self.provider.embed_texts(embed_names)
        except ProviderUnavailable as exc:
            # only a provider that reports itself unavailable (HTTP) is
            # skipped; an encoder's error propagates (the reference skips
            # every exception, which would drop all semantic edges quietly)
            logger.warning("semantic match embedding failed: %s", exc)
            return 0
        sym_idx = {name: i for i, name in enumerate(embed_names)}
        tgt_idx = {name: i for i, name in enumerate(presel.keys())}

        resolved_names: Dict[str, Optional[CodeNode]] = {}
        for t, cands in presel.items():
            te = target_embs[tgt_idx[t]]
            best, best_score = None, self.semantic_threshold
            for s in cands:
                score = float(te @ symbol_embs[sym_idx[s]])
                if score >= best_score:
                    best, best_score = s, score
            resolved_names[t] = symbols[best][0] if best else None

        n = 0
        for edge in pending:
            node = resolved_names.get(edge.dst)
            if node is not None:
                edge.dst = node.id
                edge.resolved = True
                n += 1
        return n


__all__ = ["EdgeResolver", "SEMANTIC_THRESHOLD", "parse_import_aliases"]

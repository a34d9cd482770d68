"""Copy of `codegraph_tpu/core/types.py` for the PyTorch port.

Core record types: nodes, edges, chunks, and deterministic ids.

Capability parity with the reference's codegraph-core type layer
(reference: crates/codegraph-core/src/types.rs:8-180, src/node.rs:5-92):
deterministic SHA-256-derived node ids, Language/NodeType/EdgeType enums,
and the CodeNode record. Re-designed as plain dataclasses — host-side
metadata only; all numeric state (embeddings, adjacency) lives in device
arrays owned by the index/graph layers, never inside per-node objects.
"""

from __future__ import annotations

import hashlib
import uuid
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, Iterable, List, Optional, Tuple


class Language(str, Enum):
    """Languages the parser can extract (reference supports 13:
    crates/codegraph-parser/src/languages/mod.rs:102)."""

    RUST = "rust"
    PYTHON = "python"
    JAVASCRIPT = "javascript"
    TYPESCRIPT = "typescript"
    GO = "go"
    JAVA = "java"
    CPP = "cpp"
    CSHARP = "csharp"
    RUBY = "ruby"
    PHP = "php"
    SWIFT = "swift"
    KOTLIN = "kotlin"
    DART = "dart"
    OTHER = "other"


# extension -> Language (reference: codegraph-parser/src/language.rs)
EXTENSION_LANGUAGES: Dict[str, Language] = {
    ".rs": Language.RUST,
    ".py": Language.PYTHON,
    ".pyi": Language.PYTHON,
    ".js": Language.JAVASCRIPT,
    ".jsx": Language.JAVASCRIPT,
    ".mjs": Language.JAVASCRIPT,
    ".cjs": Language.JAVASCRIPT,
    ".ts": Language.TYPESCRIPT,
    ".tsx": Language.TYPESCRIPT,
    ".go": Language.GO,
    ".java": Language.JAVA,
    ".c": Language.CPP,
    ".h": Language.CPP,
    ".cc": Language.CPP,
    ".cpp": Language.CPP,
    ".cxx": Language.CPP,
    ".hpp": Language.CPP,
    ".hh": Language.CPP,
    ".cs": Language.CSHARP,
    ".rb": Language.RUBY,
    ".php": Language.PHP,
    ".swift": Language.SWIFT,
    ".kt": Language.KOTLIN,
    ".kts": Language.KOTLIN,
    ".dart": Language.DART,
}


class NodeType(str, Enum):
    """Node kinds in the code graph (reference: types.rs:36-70)."""

    FUNCTION = "function"
    METHOD = "method"
    STRUCT = "struct"
    CLASS = "class"
    INTERFACE = "interface"
    TRAIT = "trait"
    ENUM = "enum"
    MODULE = "module"
    VARIABLE = "variable"
    CONSTANT = "constant"
    TYPE_ALIAS = "type_alias"
    IMPORT = "import"
    MACRO = "macro"
    FILE = "file"
    PACKAGE = "package"
    DOC = "doc"
    OTHER = "other"


class EdgeType(str, Enum):
    """Edge kinds (reference: types.rs:71-105 + analyzers).

    `CALLS`/`USES`/`DEPENDS_ON` are the hybrid-search boost edges
    (reference: schema/codegraph.surql:481-511 edge-context join).
    """

    CALLS = "calls"
    USES = "uses"
    DEPENDS_ON = "depends_on"
    IMPORTS = "imports"
    DEFINES = "defines"
    CONTAINS = "contains"
    IMPLEMENTS = "implements"
    EXTENDS = "extends"
    RETURNS = "returns"
    MUTATES = "mutates"
    FLOWS_TO = "flows_to"
    REFERENCES = "references"
    ENABLES = "enables"
    VIOLATES_BOUNDARY = "violates_boundary"
    OTHER = "other"


# int codes for device-side CSR edge-type arrays (stable ordering)
EDGE_TYPE_CODES: Dict[EdgeType, int] = {e: i for i, e in enumerate(EdgeType)}
EDGE_TYPE_BY_CODE: Dict[int, EdgeType] = {i: e for e, i in EDGE_TYPE_CODES.items()}

# int codes for device-side per-row attribute arrays (search filter masks)
LANGUAGE_CODES: Dict[Language, int] = {l: i for i, l in enumerate(Language)}
NODE_TYPE_CODES: Dict[NodeType, int] = {t: i for i, t in enumerate(NodeType)}


def path_prefix_match(path: str, prefix: str) -> bool:
    """True when `prefix` matches `path` from the start (reference
    semantics, search.rs:446-449 starts_with) OR from any directory
    boundary — indexed paths are absolute, users pass project-relative
    prefixes like "web/" or "src/parser"."""
    return path.startswith(prefix) or f"/{prefix}" in f"/{path}"


@dataclass(frozen=True)
class SearchFilters:
    """Search-time filters (reference: crates/codegraph-vector/src/
    search.rs:23-28 SearchFilters{languages, node_types,
    attribute_equals, path_prefixes}; :420-461 node_matches_filters +
    metadata_match_score; metadata-filtered KNN
    surrealdb_storage.rs:331).

    TPU-native application differs from the reference's host post-filter:
    languages / node_types / path_prefixes / attribute_equals are applied
    DEVICE-SIDE as a NEG_INF bias mask added to the index's existing bias
    vector (zero extra kernel work, no prefetch recall loss). The same
    dimensions also produce a [0,1] metadata_match_score that feeds
    ranking via SearchConfig.metadata_weight (search.rs:333)."""

    languages: Tuple[str, ...] = ()
    node_types: Tuple[str, ...] = ()
    path_prefixes: Tuple[str, ...] = ()
    attribute_equals: Tuple[Tuple[str, str], ...] = ()
    # soft=True: no hard exclusion — the filter dimensions contribute a
    # metadata_match_score to RANKING only (the reference's
    # hybrid_search soft mix, search.rs:317-345). soft=False (default)
    # excludes non-matching rows device-side (node_matches_filters
    # semantics, search.rs:296-307).
    soft: bool = False

    @classmethod
    def make(
        cls,
        languages: Optional[Iterable[str]] = None,
        node_types: Optional[Iterable[str]] = None,
        path_prefixes: Optional[Iterable[str]] = None,
        metadata: Optional[Dict[str, Any]] = None,
        soft: bool = False,
    ) -> "SearchFilters":
        return cls(
            languages=tuple(sorted({str(x).lower() for x in (languages or ())})),
            node_types=tuple(sorted({str(x).lower() for x in (node_types or ())})),
            path_prefixes=tuple(sorted({str(x) for x in (path_prefixes or ())})),
            attribute_equals=tuple(
                sorted((str(k), str(v)) for k, v in (metadata or {}).items())
            ),
            soft=bool(soft),
        )

    @property
    def empty(self) -> bool:
        return not (
            self.languages or self.node_types or self.path_prefixes
            or self.attribute_equals
        )

    def key(self) -> Tuple:
        """Canonical hashable identity for caches."""
        return (self.languages, self.node_types, self.path_prefixes,
                self.attribute_equals, self.soft)

    def matches_node(self, node: "CodeNode") -> bool:
        """Host-side oracle / fallback (search.rs:420-446 semantics)."""
        if self.languages and node.language.value not in self.languages:
            return False
        if self.node_types and node.node_type.value not in self.node_types:
            return False
        if self.attribute_equals:
            for k, v in self.attribute_equals:
                if str(node.metadata.get(k)) != v:
                    return False
        if self.path_prefixes and not any(
            path_prefix_match(node.location.file_path, p)
            for p in self.path_prefixes
        ):
            return False
        return True

    def metadata_match_score(self, node: "CodeNode") -> float:
        """Fractional per-dimension match (search.rs:461-515)."""
        score = denom = 0.0
        if self.languages:
            denom += 1.0
            if node.language.value in self.languages:
                score += 1.0
        if self.node_types:
            denom += 1.0
            if node.node_type.value in self.node_types:
                score += 1.0
        if self.attribute_equals:
            denom += 1.0
            if all(
                str(node.metadata.get(k)) == v
                for k, v in self.attribute_equals
            ):
                score += 1.0
        if self.path_prefixes:
            denom += 1.0
            if any(
                path_prefix_match(node.location.file_path, p)
                for p in self.path_prefixes
            ):
                score += 1.0
        return score / denom if denom else 0.0


def deterministic_node_id(
    project: str, file_path: str, name: str, node_type: str, start_line: int
) -> str:
    """Deterministic node id: UUID derived from SHA-256 of identity fields.

    Same idempotent-reindex property as the reference
    (crates/codegraph-core/src/types.rs:12-35): re-parsing an unchanged
    file reproduces identical ids, making delete-then-insert incremental
    indexing safe.
    """
    h = hashlib.sha256(
        f"{project}\x1f{file_path}\x1f{name}\x1f{node_type}\x1f{start_line}".encode()
    ).digest()
    return str(uuid.UUID(bytes=h[:16]))


def content_hash(text: str) -> str:
    """Content hash used by the file-metadata change detector
    (reference: indexer.rs:3186-3254 file_metadata change detection)."""
    return hashlib.sha256(text.encode("utf-8", errors="replace")).hexdigest()


@dataclass
class Location:
    file_path: str
    start_line: int = 0
    end_line: int = 0
    start_col: int = 0
    end_col: int = 0


@dataclass
class CodeNode:
    """A code entity (reference: codegraph-core/src/node.rs:5-16).

    No embedding field — embeddings live in the device-resident index
    matrix, addressed by row; `row` is assigned at index build.
    """

    id: str
    name: str
    node_type: NodeType
    language: Language
    location: Location
    content: str = ""
    complexity: int = 0
    metadata: Dict[str, Any] = field(default_factory=dict)
    row: int = -1  # row in the graph's node table (assigned at build)

    @staticmethod
    def make(
        project: str,
        name: str,
        node_type: NodeType,
        language: Language,
        location: Location,
        content: str = "",
        complexity: int = 0,
        metadata: Optional[Dict[str, Any]] = None,
    ) -> "CodeNode":
        nid = deterministic_node_id(
            project, location.file_path, name, node_type.value, location.start_line
        )
        return CodeNode(
            id=nid,
            name=name,
            node_type=node_type,
            language=language,
            location=location,
            content=content,
            complexity=complexity,
            metadata=metadata or {},
        )


@dataclass
class CodeEdge:
    """from/to/type/weight edge (reference: codegraph-graph/src/edge.rs)."""

    src: str  # node id
    dst: str  # node id (may be an unresolved symbol name before resolution)
    edge_type: EdgeType
    weight: float = 1.0
    metadata: Dict[str, Any] = field(default_factory=dict)
    resolved: bool = True


@dataclass
class CodeChunk:
    """A tokenizer-budgeted chunk of a node's text; the retrieval unit
    (reference: chunks table, schema/codegraph.surql:787-826; chunker
    crates/codegraph-vector/src/prep/chunker.rs:74-100)."""

    id: str
    parent_node: str  # CodeNode.id
    text: str
    chunk_index: int = 0
    n_chunks: int = 1
    row: int = -1  # row in the embedding matrix (assigned at index build)

    @staticmethod
    def make(parent_node: str, text: str, chunk_index: int, n_chunks: int) -> "CodeChunk":
        h = hashlib.sha256(f"{parent_node}\x1f{chunk_index}\x1f{text}".encode()).digest()
        return CodeChunk(
            id=str(uuid.UUID(bytes=h[:16])),
            parent_node=parent_node,
            text=text,
            chunk_index=chunk_index,
            n_chunks=n_chunks,
        )


@dataclass
class SearchResult:
    """A single hybrid-search hit returned to callers/tools."""

    node_id: str
    chunk_id: str
    score: float
    vector_score: float = 0.0
    text_score: float = 0.0
    graph_boost: float = 0.0
    name: str = ""
    node_type: str = ""
    file_path: str = ""
    start_line: int = 0
    end_line: int = 0
    snippet: str = ""
    metadata_score: float = 0.0
    # per-hit edge EVIDENCE (reference: schema/codegraph.surql:481-536
    # attaches the joined edge rows to every hit, not just a score):
    # [{"node_id", "name", "relation", "direction", "weight"}, ...]
    related: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "node_id": self.node_id,
            "chunk_id": self.chunk_id,
            "score": round(float(self.score), 6),
            "vector_score": round(float(self.vector_score), 6),
            "text_score": round(float(self.text_score), 6),
            "graph_boost": round(float(self.graph_boost), 6),
            "name": self.name,
            "node_type": self.node_type,
            "file_path": self.file_path,
            "start_line": self.start_line,
            "end_line": self.end_line,
            "snippet": self.snippet,
        }
        if self.metadata_score:
            d["metadata_score"] = round(float(self.metadata_score), 6)
        if self.related:
            d["related"] = self.related
        return d


def language_for_path(path: str) -> Optional[Language]:
    import os

    _, ext = os.path.splitext(path)
    return EXTENSION_LANGUAGES.get(ext.lower())


__all__ = [
    "Language",
    "NodeType",
    "EdgeType",
    "EDGE_TYPE_CODES",
    "EDGE_TYPE_BY_CODE",
    "LANGUAGE_CODES",
    "NODE_TYPE_CODES",
    "SearchFilters",
    "EXTENSION_LANGUAGES",
    "Location",
    "CodeNode",
    "CodeEdge",
    "CodeChunk",
    "SearchResult",
    "deterministic_node_id",
    "content_hash",
    "language_for_path",
]

"""Copy of `codegraph_tpu/parser/extractors.py` for the PyTorch port.

Per-language node/edge extraction (13 languages).

Reference: crates/codegraph-parser/src/languages/*.rs (13 tree-sitter
extractors producing ExtractionResult{nodes, edges}) + the FastML
pattern/symbol pass (src/fast_ml/pattern_matcher.rs:29,
symbol_resolver.rs:36-81). Python extraction is exact (stdlib `ast`);
the other 12 languages run the string/comment-aware lexer + scope
scanners (parser/lexer.py + parser/scanners.py): nested CONTAINS
(method -> class/impl/trait), EXTENDS/IMPLEMENTS heritage edges, and
no declaration/call matches inside literals. Call/use edges are
emitted *unresolved* (dst = symbol name); the indexer's resolution
stage maps them to node ids (reference: indexer.rs:2673).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import List, Optional

from codegraph_tpu_torch.core.types import (
    CodeEdge,
    CodeNode,
    EdgeType,
    Language,
    Location,
    NodeType,
)
from codegraph_tpu_torch.parser.complexity import cyclomatic_complexity

MAX_NODE_LINES = 500


@dataclass
class ExtractionResult:
    nodes: List[CodeNode] = field(default_factory=list)
    edges: List[CodeEdge] = field(default_factory=list)


# ---------------------------------------------------------------------------
# Python: exact AST extraction
# ---------------------------------------------------------------------------

_PY_BUILTINS = frozenset((
    "print", "len", "range", "str", "int", "float", "list", "dict", "set",
    "tuple", "isinstance", "super", "type", "enumerate", "zip", "map",
    "filter", "sorted", "min", "max", "sum", "abs", "open", "getattr",
    "setattr", "hasattr", "repr", "iter", "next", "vars", "id", "bool",
))


def _extract_python(project: str, path: str, text: str) -> ExtractionResult:
    result = ExtractionResult()
    try:
        tree = ast.parse(text)
    except SyntaxError:
        return result
    lines = text.splitlines()

    def node_text(a: ast.AST) -> str:
        start = a.lineno - 1
        end = getattr(a, "end_lineno", a.lineno)
        return "\n".join(lines[start:end][:MAX_NODE_LINES])

    def calls_in(a: ast.AST) -> List[str]:
        names = []
        for sub in ast.walk(a):
            if isinstance(sub, ast.Call):
                fn = sub.func
                if isinstance(fn, ast.Name) and fn.id not in _PY_BUILTINS:
                    names.append(fn.id)
                elif isinstance(fn, ast.Attribute):
                    names.append(fn.attr)
        return names

    def add_def(a, ntype: NodeType, parent: Optional[CodeNode]) -> CodeNode:
        loc = Location(path, a.lineno, getattr(a, "end_lineno", a.lineno))
        node = CodeNode.make(
            project, a.name, ntype, Language.PYTHON, loc,
            content=node_text(a), complexity=cyclomatic_complexity(node_text(a)),
        )
        result.nodes.append(node)
        if parent is not None:
            result.edges.append(CodeEdge(parent.id, node.id, EdgeType.CONTAINS))
        for callee in set(calls_in(a)):
            if callee != a.name:
                result.edges.append(
                    CodeEdge(node.id, callee, EdgeType.CALLS, resolved=False)
                )
        return node

    def visit_body(body, parent: Optional[CodeNode]):
        for a in body:
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ntype = NodeType.METHOD if parent and parent.node_type in (
                    NodeType.CLASS,
                ) else NodeType.FUNCTION
                fn = add_def(a, ntype, parent)
                visit_body(a.body, fn)
            elif isinstance(a, ast.ClassDef):
                cls = add_def(a, NodeType.CLASS, parent)
                for base in a.bases:
                    base_name = (
                        base.id if isinstance(base, ast.Name)
                        else base.attr if isinstance(base, ast.Attribute) else None
                    )
                    if base_name:
                        result.edges.append(CodeEdge(
                            cls.id, base_name, EdgeType.EXTENDS, resolved=False
                        ))
                visit_body(a.body, cls)
            elif isinstance(a, (ast.Import, ast.ImportFrom)):
                mod = (
                    a.module if isinstance(a, ast.ImportFrom) and a.module
                    else ",".join(n.name for n in a.names)
                )
                loc = Location(path, a.lineno, a.lineno)
                imp = CodeNode.make(
                    project, mod or "import", NodeType.IMPORT, Language.PYTHON,
                    loc, content=node_text(a),
                )
                result.nodes.append(imp)
                result.edges.append(CodeEdge(
                    imp.id, mod or "", EdgeType.IMPORTS, resolved=False
                ))

    visit_body(tree.body, None)
    return result


def extract_file(
    project: str, path: str, text: str, language: Language
) -> ExtractionResult:
    """Extract nodes + (possibly unresolved) edges from one file, plus a
    FILE node that CONTAINS every top-level entity."""
    if language == Language.PYTHON:
        result = _extract_python(project, path, text)
    else:
        from codegraph_tpu_torch.parser.scanners import scan_file

        nodes, edges = scan_file(project, path, text, language)
        result = ExtractionResult(nodes=nodes, edges=edges)

    n_lines = text.count("\n") + 1
    file_node = CodeNode.make(
        project, path.rsplit("/", 1)[-1], NodeType.FILE, language,
        Location(path, 1, n_lines), content="",
    )
    contained = {e.dst for e in result.edges if e.edge_type == EdgeType.CONTAINS}
    for node in result.nodes:
        if node.id not in contained:
            result.edges.append(CodeEdge(file_node.id, node.id, EdgeType.CONTAINS))
    result.nodes.append(file_node)
    return result


__all__ = ["ExtractionResult", "extract_file"]

"""Copy of `codegraph_tpu/parser/semantic.py` for the PyTorch port.

Semantic analysis: scopes, symbol tables, references, change impact.

Reference: crates/codegraph-parser/src/semantic.rs:147-1032 — a
scope/symbol/reference model with per-language analyzers (:407-907) and
compute_change_impact (:256). Re-design: scopes nest by extraction
containment (file -> class -> function); the symbol table resolves a
reference by walking outward through enclosing scopes; change impact is
the transitive closure of reverse references.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set

from codegraph_tpu_torch.core.types import CodeEdge, CodeNode, EdgeType, NodeType


@dataclass
class Scope:
    scope_id: int
    owner: Optional[str]  # node id ("" for file/global scope)
    parent: Optional[int]
    symbols: Dict[str, str] = field(default_factory=dict)  # name -> node id
    children: List[int] = field(default_factory=list)


@dataclass
class Reference:
    from_node: str
    to_symbol: str
    resolved_to: Optional[str] = None


class SemanticModel:
    """Scope tree + symbol resolution for one parsed file set."""

    def __init__(self) -> None:
        self.scopes: List[Scope] = []
        self.node_scope: Dict[str, int] = {}
        self.references: List[Reference] = []

    def new_scope(self, owner: Optional[str], parent: Optional[int]) -> int:
        sid = len(self.scopes)
        self.scopes.append(Scope(sid, owner, parent))
        if parent is not None:
            self.scopes[parent].children.append(sid)
        return sid

    def declare(self, scope_id: int, name: str, node_id: str) -> None:
        self.scopes[scope_id].symbols[name] = node_id

    def resolve(self, scope_id: int, name: str) -> Optional[str]:
        """Walk outward through enclosing scopes (semantic.rs lookup)."""
        sid: Optional[int] = scope_id
        while sid is not None:
            scope = self.scopes[sid]
            if name in scope.symbols:
                return scope.symbols[name]
            sid = scope.parent
        return None


class SemanticAnalyzer:
    """Builds the semantic model from extracted nodes/edges and resolves
    references scope-aware (more precise than the global symbol map the
    edge resolver uses: an inner helper shadows a same-named global)."""

    _CONTAINER_TYPES = {NodeType.FILE, NodeType.CLASS, NodeType.STRUCT,
                        NodeType.TRAIT, NodeType.INTERFACE, NodeType.MODULE}

    def build(
        self, nodes: Sequence[CodeNode], edges: Sequence[CodeEdge]
    ) -> SemanticModel:
        model = SemanticModel()
        by_id = {n.id: n for n in nodes}
        contains: Dict[str, List[str]] = defaultdict(list)
        contained: Set[str] = set()
        for e in edges:
            if e.edge_type == EdgeType.CONTAINS and e.dst in by_id:
                contains[e.src].append(e.dst)
                contained.add(e.dst)

        global_scope = model.new_scope(None, None)

        def visit(node_id: str, parent_scope: int) -> None:
            node = by_id[node_id]
            model.declare(parent_scope, node.name, node_id)
            scope = model.new_scope(node_id, parent_scope)
            model.node_scope[node_id] = scope
            for child in contains.get(node_id, []):
                visit(child, scope)

        for node in nodes:
            if node.id not in contained:
                visit(node.id, global_scope)

        # resolve call/use references scope-aware
        for e in edges:
            if e.edge_type not in (EdgeType.CALLS, EdgeType.USES) or e.resolved:
                continue
            src_scope = model.node_scope.get(e.src, global_scope)
            ref = Reference(from_node=e.src, to_symbol=e.dst)
            ref.resolved_to = model.resolve(src_scope, e.dst)
            model.references.append(ref)
        return model

    def compute_change_impact(
        self,
        changed_nodes: Sequence[str],
        nodes: Sequence[CodeNode],
        edges: Sequence[CodeEdge],
        max_depth: int = 3,
    ) -> Dict[str, int]:
        """Transitive closure of reverse references from the changed set
        (semantic.rs:256 compute_change_impact): returns
        {impacted_node_id: distance}."""
        reverse: Dict[str, List[str]] = defaultdict(list)
        for e in edges:
            if e.resolved and e.edge_type in (
                EdgeType.CALLS, EdgeType.USES, EdgeType.DEPENDS_ON,
                EdgeType.IMPORTS,
            ):
                reverse[e.dst].append(e.src)
        impact: Dict[str, int] = {}
        frontier = list(changed_nodes)
        for depth in range(1, max_depth + 1):
            nxt: List[str] = []
            for nid in frontier:
                for dep in reverse.get(nid, []):
                    if dep not in impact and dep not in changed_nodes:
                        impact[dep] = depth
                        nxt.append(dep)
            frontier = nxt
            if not frontier:
                break
        return impact


__all__ = ["SemanticAnalyzer", "SemanticModel", "Scope", "Reference"]

"""Copy of `codegraph_tpu/graph/propagation.py` for the PyTorch port.

Change-impact propagation through the graph.

Reference: crates/codegraph-core/src/propagation/manager.rs (553 LoC) +
src/incremental/updater.rs (726 LoC) — when files change, compute which
dependent nodes are impacted, prioritize, and plan downstream work
(re-embed, re-analyze, notify watchers). Runs over the CSR reverse
adjacency; cost decays with distance so direct callers outrank
3-hop-away modules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Set

from codegraph_tpu_torch.core.types import EDGE_TYPE_CODES, EdgeType
from codegraph_tpu_torch.graph.store import GraphStore

IMPACT_EDGE_CODES = tuple(
    EDGE_TYPE_CODES[e]
    for e in (EdgeType.CALLS, EdgeType.USES, EdgeType.DEPENDS_ON,
              EdgeType.IMPORTS, EdgeType.EXTENDS, EdgeType.IMPLEMENTS)
)


@dataclass
class ImpactedNode:
    node_id: str
    name: str
    file_path: str
    distance: int
    score: float  # decayed impact priority


@dataclass
class PropagationPlan:
    changed: List[str]
    impacted: List[ImpactedNode]
    files_to_reanalyze: List[str]

    @property
    def total_impacted(self) -> int:
        return len(self.impacted)


class PropagationManager:
    def __init__(self, store: GraphStore, decay: float = 0.5,
                 max_depth: int = 3):
        self.store = store
        self.decay = decay
        self.max_depth = max_depth

    def plan_for_files(self, changed_files: Sequence[str]) -> PropagationPlan:
        changed_nodes = [
            nid
            for path in changed_files
            for nid in self.store.file_nodes.get(path, [])
        ]
        return self.plan_for_nodes(changed_nodes)

    def plan_for_nodes(self, changed_nodes: Sequence[str]) -> PropagationPlan:
        csr = self.store.csr()
        changed_rows = {
            self.store.node_rows[nid]
            for nid in changed_nodes
            if nid in self.store.node_rows
        }
        dist: Dict[int, int] = {r: 0 for r in changed_rows}
        frontier = list(changed_rows)
        for depth in range(1, self.max_depth + 1):
            nxt: List[int] = []
            for row in frontier:
                for nbr in csr.reverse_neighbors(row, IMPACT_EDGE_CODES):
                    nb = int(nbr)
                    if nb not in dist:
                        dist[nb] = depth
                        nxt.append(nb)
            frontier = nxt
            if not frontier:
                break

        impacted: List[ImpactedNode] = []
        files: Set[str] = set()
        for row, depth in dist.items():
            if depth == 0:
                continue
            node = self.store.node_by_row(row)
            if node is None:
                continue
            impacted.append(ImpactedNode(
                node_id=node.id, name=node.name,
                file_path=node.location.file_path, distance=depth,
                score=self.decay ** (depth - 1),
            ))
            files.add(node.location.file_path)
        impacted.sort(key=lambda n: (-n.score, n.name))
        return PropagationPlan(
            changed=list(changed_nodes),
            impacted=impacted,
            files_to_reanalyze=sorted(files),
        )


__all__ = ["PropagationManager", "PropagationPlan", "ImpactedNode"]

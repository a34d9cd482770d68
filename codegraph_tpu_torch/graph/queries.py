"""Copy of `codegraph_tpu/graph/queries.py` for the PyTorch port.

Graph analytics over CSR — the agent-facing graph query engine.

Host-side re-implementation of the reference's SurrealQL graph functions
(crates/codegraph-graph/src/graph_functions.rs:73-922 typed wrappers over
fn::* in schema/codegraph.surql): transitive deps, circular deps, call
chains, coupling metrics, hub nodes, reverse deps, complexity hotspots.
SurrealQL graph walks become array algorithms over the CSR arrays
(graph/csr.py) — BFS frontiers as index arrays, SCC via iterative
Tarjan — which is also the representation the device boost kernel shares.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from codegraph_tpu_torch.core.types import EDGE_TYPE_CODES, EdgeType
from codegraph_tpu_torch.graph.store import GraphStore

DEP_EDGE_CODES = tuple(
    EDGE_TYPE_CODES[e]
    for e in (EdgeType.DEPENDS_ON, EdgeType.IMPORTS, EdgeType.CALLS, EdgeType.USES)
)
CALL_EDGE_CODES = (EDGE_TYPE_CODES[EdgeType.CALLS],)
MAX_DEPTH = 5  # reference clamps traversal depth <= 5 (graph_tool_schemas.rs)


class GraphQueries:
    """The structural graph tools: find-by-name + the 7 analytics\n    (semantic search lives in search/)."""

    def __init__(self, store: GraphStore):
        self.store = store

    def _node_info(self, row: int) -> Optional[Dict[str, Any]]:
        node = self.store.node_by_row(row)
        if node is None:
            return None
        return {
            "id": node.id,
            "name": node.name,
            "node_type": node.node_type.value,
            "file_path": node.location.file_path,
            "start_line": node.location.start_line,
            "complexity": node.complexity,
        }

    def _resolve_start(self, node_id_or_name: str) -> Optional[int]:
        row = self.store.node_rows.get(node_id_or_name)
        if row is not None:
            return row
        matches = self.store.find_nodes_by_name(node_id_or_name)
        return matches[0].row if matches else None

    # -- 0. find nodes by name (graph_functions.rs:473) --------------------

    def find_nodes_by_name(
        self, name: str, limit: int = 20, fuzzy: bool = True
    ) -> Dict[str, Any]:
        """Public name lookup: exact matches first, then substring
        (reference: fn::find_nodes_by_name, graph_functions.rs:473)."""
        matches = self.store.find_nodes_by_name(name, fuzzy=fuzzy)
        exact = [n for n in matches if n.name == name]
        rest = [n for n in matches if n.name != name]
        ordered = exact + sorted(rest, key=lambda n: (len(n.name), n.name))
        infos = []
        for n in ordered[:limit]:
            info = self._node_info(n.row)
            if info is not None:
                info["exact"] = n.name == name
                infos.append(info)
        return {"query": name, "count": len(infos), "nodes": infos}

    # -- 1. transitive dependencies (graph_functions.rs:191) ---------------

    def transitive_dependencies(
        self, node: str, max_depth: int = 3, etypes: Sequence[int] = DEP_EDGE_CODES
    ) -> Dict[str, Any]:
        start = self._resolve_start(node)
        if start is None:
            return {"error": f"node {node!r} not found", "dependencies": []}
        max_depth = min(max_depth, MAX_DEPTH)
        csr = self.store.csr()
        seen: Dict[int, int] = {start: 0}
        frontier = [start]
        for depth in range(1, max_depth + 1):
            nxt: List[int] = []
            for row in frontier:
                for nbr in csr.neighbors(row, etypes):
                    if int(nbr) not in seen:
                        seen[int(nbr)] = depth
                        nxt.append(int(nbr))
            frontier = nxt
            if not frontier:
                break
        deps = []
        for row, depth in seen.items():
            if row == start:
                continue
            info = self._node_info(row)
            if info:
                info["depth"] = depth
                deps.append(info)
        deps.sort(key=lambda d: (d["depth"], d["name"]))
        return {"start": self._node_info(start), "count": len(deps),
                "dependencies": deps}

    # -- 2. circular dependencies (graph_functions.rs:232) -----------------

    def circular_dependencies(
        self, etypes: Sequence[int] = DEP_EDGE_CODES, max_cycles: int = 50
    ) -> Dict[str, Any]:
        """SCCs of size > 1 via iterative Tarjan (surql fn::detect_circular
        _dependencies re-done as a linear-time SCC pass)."""
        csr = self.store.csr()
        n = csr.n_nodes
        index = np.full(n, -1, np.int64)
        low = np.zeros(n, np.int64)
        on_stack = np.zeros(n, bool)
        stack: List[int] = []
        sccs: List[List[int]] = []
        counter = 0
        for root in range(n):
            if index[root] != -1:
                continue
            work: List[Tuple[int, int]] = [(root, 0)]
            while work:
                v, pi = work[-1]
                if pi == 0:
                    index[v] = low[v] = counter
                    counter += 1
                    stack.append(v)
                    on_stack[v] = True
                nbrs = csr.neighbors(v, etypes)
                advanced = False
                for j in range(pi, len(nbrs)):
                    w = int(nbrs[j])
                    if index[w] == -1:
                        work[-1] = (v, j + 1)
                        work.append((w, 0))
                        advanced = True
                        break
                    if on_stack[w]:
                        low[v] = min(low[v], index[w])
                if advanced:
                    continue
                if low[v] == index[v]:
                    scc = []
                    while True:
                        w = stack.pop()
                        on_stack[w] = False
                        scc.append(w)
                        if w == v:
                            break
                    if len(scc) > 1:
                        sccs.append(scc)
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent] = min(low[parent], low[v])
        cycles = []
        for scc in sccs[:max_cycles]:
            members = [self._node_info(r) for r in scc]
            cycles.append({"size": len(scc),
                           "members": [m for m in members if m]})
        cycles.sort(key=lambda c: -c["size"])
        return {"count": len(sccs), "cycles": cycles}

    # -- 3. call chain (graph_functions.rs:268) ----------------------------

    def trace_call_chain(
        self, source: str, target: Optional[str] = None, max_depth: int = 5
    ) -> Dict[str, Any]:
        start = self._resolve_start(source)
        if start is None:
            return {"error": f"node {source!r} not found", "paths": []}
        max_depth = min(max_depth, MAX_DEPTH)
        goal = self._resolve_start(target) if target else None
        if target and goal is None:
            return {"error": f"node {target!r} not found", "paths": []}
        csr = self.store.csr()
        paths: List[List[int]] = []
        q: deque = deque([[start]])
        visited = {start}
        while q and len(paths) < 50:
            path = q.popleft()
            if len(path) > max_depth:
                continue
            for nbr in csr.neighbors(path[-1], CALL_EDGE_CODES):
                nb = int(nbr)
                new_path = path + [nb]
                if goal is not None:
                    if nb == goal:
                        paths.append(new_path)
                    elif nb not in visited and len(new_path) <= max_depth:
                        visited.add(nb)
                        q.append(new_path)
                else:
                    if nb not in visited:
                        visited.add(nb)
                        paths.append(new_path)
                        q.append(new_path)
        out = [
            {"depth": len(p) - 1,
             "chain": [self._node_info(r) for r in p]}
            for p in paths
        ]
        return {"start": self._node_info(start),
                "target": self._node_info(goal) if goal is not None else None,
                "count": len(out), "paths": out}

    # -- 4. coupling metrics (graph_functions.rs:305) ----------------------

    def coupling_metrics(self, node: str) -> Dict[str, Any]:
        row = self._resolve_start(node)
        if row is None:
            return {"error": f"node {node!r} not found"}
        csr = self.store.csr()
        efferent = len(set(int(x) for x in csr.neighbors(row, DEP_EDGE_CODES)))
        afferent = len(set(int(x) for x in csr.reverse_neighbors(row, DEP_EDGE_CODES)))
        total = efferent + afferent
        instability = efferent / total if total else 0.0
        return {
            "node": self._node_info(row),
            "efferent_coupling": efferent,
            "afferent_coupling": afferent,
            "instability": round(instability, 4),
            "classification": (
                "stable" if instability < 0.3
                else "unstable" if instability > 0.7 else "balanced"
            ),
        }

    # -- 5. hub nodes (graph_functions.rs:344) -----------------------------

    def hub_nodes(self, limit: int = 10) -> Dict[str, Any]:
        csr = self.store.csr()
        # degrees computed ONCE: each call is an O(n) np.diff over the
        # full indptr, so per-hub recomputation cost 2*limit O(n) passes
        outd = csr.out_degree()
        ind = csr.in_degree()
        degree = outd + ind
        order = np.argsort(-degree)[: limit * 2]
        hubs = []
        for row in order:
            if degree[row] == 0:
                break
            info = self._node_info(int(row))
            if info:
                info["degree"] = int(degree[row])
                info["out_degree"] = int(outd[row])
                info["in_degree"] = int(ind[row])
                hubs.append(info)
            if len(hubs) >= limit:
                break
        return {"count": len(hubs), "hubs": hubs}

    # -- 6. reverse dependencies (graph_functions.rs:378) ------------------

    def reverse_dependencies(self, node: str, max_depth: int = 2) -> Dict[str, Any]:
        start = self._resolve_start(node)
        if start is None:
            return {"error": f"node {node!r} not found", "dependents": []}
        max_depth = min(max_depth, MAX_DEPTH)
        csr = self.store.csr()
        seen: Dict[int, int] = {start: 0}
        frontier = [start]
        for depth in range(1, max_depth + 1):
            nxt = []
            for row in frontier:
                for nbr in csr.reverse_neighbors(row, DEP_EDGE_CODES):
                    if int(nbr) not in seen:
                        seen[int(nbr)] = depth
                        nxt.append(int(nbr))
            frontier = nxt
        dependents = []
        for row, depth in seen.items():
            if row == start:
                continue
            info = self._node_info(row)
            if info:
                info["depth"] = depth
                dependents.append(info)
        dependents.sort(key=lambda d: (d["depth"], d["name"]))
        return {"start": self._node_info(start), "count": len(dependents),
                "dependents": dependents}

    # -- 7. complexity hotspots (graph_functions.rs:418) -------------------

    def complexity_hotspots(self, limit: int = 10) -> Dict[str, Any]:
        """Rank by complexity x connectivity — complex AND central code is
        the real hotspot (the reference weighs complexity with hub-ness)."""
        csr = self.store.csr()
        degree = csr.out_degree() + csr.in_degree()
        scored = []
        for node in self.store.nodes.values():
            if node.complexity <= 1:
                continue
            deg = int(degree[node.row]) if node.row < len(degree) else 0
            score = node.complexity * (1.0 + 0.1 * deg)
            scored.append((score, node))
        scored.sort(key=lambda t: -t[0])
        hotspots = []
        for score, node in scored[:limit]:
            info = self._node_info(node.row)
            if info:
                info["hotspot_score"] = round(float(score), 2)
                hotspots.append(info)
        return {"count": len(hotspots), "hotspots": hotspots}

    # -- top directories (graph_functions.rs:654) --------------------------

    def top_directories(self, limit: int = 10) -> Dict[str, Any]:
        import os

        counts: Dict[str, int] = {}
        for node in self.store.nodes.values():
            d = os.path.dirname(node.location.file_path)
            counts[d] = counts.get(d, 0) + 1
        top = sorted(counts.items(), key=lambda kv: -kv[1])[:limit]
        return {"directories": [{"path": p, "nodes": c} for p, c in top]}


__all__ = ["GraphQueries", "DEP_EDGE_CODES", "CALL_EDGE_CODES", "MAX_DEPTH"]

"""Copy of `codegraph_tpu/rag/insights.py` for the PyTorch port.

Structured insights from search + graph context.

Reference: crates/codegraph-vector/src/insights_generator.rs:73-338 —
reranked search results distilled into structured "insights" records for
the agent tools.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from codegraph_tpu_torch.graph.queries import GraphQueries


@dataclass
class Insight:
    kind: str
    title: str
    detail: str
    nodes: List[str] = field(default_factory=list)
    severity: str = "info"  # info | warning

    def to_dict(self) -> Dict:
        return self.__dict__.copy()


class InsightsGenerator:
    def __init__(self, hybrid_search, queries: GraphQueries):
        self.search = hybrid_search
        self.queries = queries

    def generate(self, topic: str, limit: int = 5) -> List[Insight]:
        insights: List[Insight] = []
        results = self.search.search_text(topic, limit)
        if results:
            insights.append(Insight(
                kind="relevant_code",
                title=f"Top code for {topic!r}",
                detail="; ".join(
                    f"{r.name} ({r.file_path}:{r.start_line})" for r in results[:3]
                ),
                nodes=[r.node_id for r in results],
            ))
            # graph context around the best hit
            top = results[0]
            coupling = self.queries.coupling_metrics(top.node_id)
            if "error" not in coupling:
                if coupling["instability"] > 0.7:
                    insights.append(Insight(
                        kind="coupling",
                        title=f"{top.name} is unstable",
                        detail=(
                            f"instability {coupling['instability']}: depends on "
                            f"{coupling['efferent_coupling']} nodes but only "
                            f"{coupling['afferent_coupling']} depend on it"
                        ),
                        nodes=[top.node_id],
                        severity="warning",
                    ))
        cycles = self.queries.circular_dependencies(max_cycles=3)
        if cycles["count"] > 0:
            insights.append(Insight(
                kind="cycles",
                title=f"{cycles['count']} dependency cycle(s)",
                detail="largest cycle has "
                       f"{cycles['cycles'][0]['size']} members",
                severity="warning",
            ))
        hotspots = self.queries.complexity_hotspots(limit=3)
        if hotspots["hotspots"]:
            h = hotspots["hotspots"][0]
            insights.append(Insight(
                kind="complexity",
                title=f"hotspot: {h['name']}",
                detail=f"complexity score {h['hotspot_score']} at "
                       f"{h['file_path']}:{h['start_line']}",
                severity="warning" if h["hotspot_score"] > 20 else "info",
            ))
        return insights[:limit]


__all__ = ["InsightsGenerator", "Insight"]

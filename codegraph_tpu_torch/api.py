"""High-level facade: one object that owns the whole stack.

Port of `codegraph_tpu/api.py` (`open`, `index`, `update_file`, `search`,
`graph`, `stats`; `ask`, `insights` and `serve` wait for ROADMAP items 18
and 19):

    from codegraph_tpu_torch.api import CodeGraph

    cg = CodeGraph.open("/path/to/repo")          # device="cuda" by default
    cg.index()
    hits = cg.search("where is the config loaded")
    deps = cg.graph.transitive_dependencies("load_config")

The default configuration embeds with the `ensemble` provider: the shipped
encoder checkpoint on the same device as the index, plus the lexical hash
half.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch

from codegraph_tpu_torch.core.config import CodeGraphConfig, load_config
from codegraph_tpu_torch.core.types import SearchResult
from codegraph_tpu_torch.graph.queries import GraphQueries
from codegraph_tpu_torch.index.flat import resolve_device
from codegraph_tpu_torch.indexer.indexer import IndexStats, ProjectIndexer
from codegraph_tpu_torch.utils.tuning import DEFAULT_HBM_BUDGET, apply_plan, plan_index


def index_memory_budget(device) -> int:
    """Bytes the planner may give the index's rows: on a CUDA device half
    of the card's memory (the reference's ratio of budget to chip memory,
    read from the card); on the CPU the reference's default, so that the
    plan equals the JAX package's."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory // 2
    return DEFAULT_HBM_BUDGET


class CodeGraph:
    def __init__(self, config: CodeGraphConfig, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        self.indexer = ProjectIndexer(config, device=self.device)
        data_dir = config.resolved_data_dir()
        if (data_dir / "store_meta.json").exists():
            self.indexer.load(str(data_dir))

    # -- construction ------------------------------------------------------

    @classmethod
    def open(
        cls,
        project_root: str,
        config: Optional[CodeGraphConfig] = None,
        auto_tune: bool = True,
        device="cuda",
        **overrides: Any,
    ) -> "CodeGraph":
        """Open a project. With auto_tune and a configured index.capacity,
        the planner (`utils/tuning.py`) picks the index tier for that many
        rows within `index_memory_budget(device)`."""
        cfg = config or load_config(overrides=overrides or None)
        cfg.project_root = os.path.abspath(project_root)
        if auto_tune and cfg.index.kind == "flat" and cfg.index.capacity:
            apply_plan(cfg, plan_index(cfg.index.capacity, cfg.embedding.dimension,
                                       hbm_budget_bytes=index_memory_budget(device)))
        return cls(cfg, device=device)

    # -- lifecycle ---------------------------------------------------------

    def index(self, force: bool = False) -> IndexStats:
        stats = self.indexer.index_project(self.config.project_root, force=force)
        self.indexer.save()
        return stats

    def update_file(self, path: str) -> Optional[IndexStats]:
        stats = self.indexer.index_single_file(path)
        self.indexer.save()
        return stats

    # -- queries -----------------------------------------------------------

    def search(self, query: str, limit: int = 10) -> List[SearchResult]:
        return self.indexer.search.search_text(query, limit)

    @property
    def graph(self) -> GraphQueries:
        return GraphQueries(self.indexer.store)

    def stats(self) -> Dict[str, Any]:
        return {
            "store": self.indexer.store.stats(),
            "index_live": len(self.indexer.index),
            "cache": self.indexer.search.cache.stats(),
            "search_perf": self.indexer.search.monitor.report(),
        }


__all__ = ["CodeGraph", "index_memory_budget"]

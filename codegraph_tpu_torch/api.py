"""High-level facade: one object that owns the whole stack.

Port of `codegraph_tpu/api.py` (`open`, `index`, `update_file`, `search`,
`stats`; the RAG, insights and MCP layers are not ported yet):

    from codegraph_tpu_torch.api import CodeGraph

    cg = CodeGraph.open("/path/to/repo")          # device="cuda" by default
    cg.index()
    hits = cg.search("where is the config loaded")
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from codegraph_tpu_torch.core.config import CodeGraphConfig, load_config
from codegraph_tpu_torch.core.types import SearchResult
from codegraph_tpu_torch.index.flat import resolve_device
from codegraph_tpu_torch.indexer.indexer import IndexStats, ProjectIndexer


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
        cfg = config or load_config(overrides=overrides or None)
        cfg.project_root = os.path.abspath(project_root)
        if auto_tune and cfg.index.kind == "flat" and cfg.index.capacity:
            raise NotImplementedError(
                "index planning for a configured capacity (utils/tuning.py "
                "plan_index) is not ported yet: ROADMAP item 7")
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

    def stats(self) -> Dict[str, Any]:
        return {
            "store": self.indexer.store.stats(),
            "index_live": len(self.indexer.index),
            "cache": self.indexer.search.cache.stats(),
            "search_perf": self.indexer.search.monitor.report(),
        }


__all__ = ["CodeGraph"]

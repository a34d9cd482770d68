"""Copy of `codegraph_tpu/indexer/estimation.py` for the PyTorch port. The
recommended index is planned within `index_memory_budget(device)`, as
`CodeGraph.open` plans it (half the card's memory on "cuda", the reference's
budget on "cpu"). The embedding rates below are the reference's priors, for
the ETA only; none was measured on the card.

Repository estimation: parse-only dry run + time/cost model.

Reference: crates/codegraph-mcp/src/estimation.rs:22-314
(RepositoryEstimator::analyze — shared unified parse with no DB writes ->
RepositoryCounts; TimeEstimates::from_node_count with provider-specific
embedding rates, :51-108).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

from codegraph_tpu_torch.core.config import CodeGraphConfig
from codegraph_tpu_torch.parser.chunker import ChunkerConfig, build_chunk_plan
from codegraph_tpu_torch.parser.parser import SourceParser

# embedding throughput priors (texts/s) per provider, for ETA only
# (reference hard-codes Jina 2000-text batches at ~9 min/batch and a local
# rate, estimation.rs:51-87; the encoder rate is a TPU-chip prior)
_PROVIDER_RATES: Dict[str, float] = {
    "hash": 50_000.0,
    "encoder": 2_000.0,
    "openai": 300.0,
    "jina": 2000.0 / 540.0,   # 2000-doc batch / ~9 min
    "ollama": 50.0,
    "lmstudio": 50.0,         # CHANGELOG.md:318 claims 50 texts/s
}


@dataclass
class RepositoryEstimate:
    files: int
    lines: int
    nodes: int
    edges: int
    symbols: int
    chunks: int
    parse_seconds: float
    embed_eta_seconds: float
    provider: str

    def to_dict(self) -> Dict:
        return {
            "files": self.files,
            "lines": self.lines,
            "nodes": self.nodes,
            "edges": self.edges,
            "symbols": self.symbols,
            "chunks": self.chunks,
            "parse_seconds": round(self.parse_seconds, 2),
            "embed_eta_seconds": round(self.embed_eta_seconds, 1),
            "provider": self.provider,
        }


class RepositoryEstimator:
    def __init__(self, config: Optional[CodeGraphConfig] = None, device="cuda"):
        from codegraph_tpu_torch.index.flat import resolve_device

        self.config = config or CodeGraphConfig()
        self.device = resolve_device(device)  # asking for CUDA without a GPU raises
        self.index_plan = None  # set by analyze(): recommended index config

    def analyze(self, root: Optional[str] = None) -> RepositoryEstimate:
        root = root or self.config.project_root
        parser = SourceParser(project=root, workers=self.config.indexing.workers)
        t0 = time.perf_counter()
        parses, pstats = parser.parse_directory(
            root,
            include_globs=self.config.indexing.include_globs or None,
            exclude_globs=self.config.indexing.exclude_globs,
            max_file_size=self.config.indexing.max_file_size,
        )
        parse_s = time.perf_counter() - t0
        nodes = [n for fp in parses for n in fp.result.nodes]
        plan = build_chunk_plan(
            nodes,
            ChunkerConfig(
                max_tokens=self.config.embedding.max_chunk_tokens,
                overlap_tokens=self.config.embedding.chunk_overlap_tokens,
            ),
        )
        symbols = len({n.name for n in nodes})
        rate = _PROVIDER_RATES.get(self.config.embedding.provider, 100.0)
        from codegraph_tpu_torch.api import index_memory_budget
        from codegraph_tpu_torch.utils.tuning import plan_index

        self.index_plan = plan_index(
            max(len(plan.chunks), 1), self.config.embedding.dimension,
            hbm_budget_bytes=index_memory_budget(self.device),
        )
        return RepositoryEstimate(
            files=pstats.parsed,
            lines=pstats.lines,
            nodes=len(nodes),
            edges=pstats.edges,
            symbols=symbols,
            chunks=len(plan.chunks),
            parse_seconds=parse_s,
            embed_eta_seconds=len(plan.chunks) / rate if rate else 0.0,
            provider=self.config.embedding.provider,
        )


__all__ = ["RepositoryEstimator", "RepositoryEstimate"]

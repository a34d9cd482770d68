"""Copy of `codegraph_tpu/core/config.py` for the PyTorch port.

Layered configuration: dataclass defaults -> TOML file -> CODEGRAPH_* env
overrides -> explicit kwargs.

Capability parity with the reference's ConfigManager
(crates/codegraph-core/src/config_manager.rs:27-1140: TOML at
~/.codegraph/config.toml, ~40 CODEGRAPH_* env overrides, validation with
warnings), flattened into a single dataclass tree because the rebuild has
far fewer moving host pieces.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger("codegraph_tpu_torch.config")

CONFIG_DIR = Path(os.environ.get("CODEGRAPH_CONFIG_DIR", Path.home() / ".codegraph"))
CONFIG_PATH = CONFIG_DIR / "config.toml"


@dataclass
class EmbeddingConfig:
    """Embedding provider + dimensions (reference: embedding_config.rs)."""

    # Default = the TRAINED quality path, matching the reference's
    # out-of-the-box behavior (embedding.rs:160,366 auto-selects a real
    # model; local_provider.rs:53-63 defaults to all-MiniLM-L6-v2): the
    # ensemble provider (shipped r3 encoder checkpoint + its BPE
    # tokenizer via checkpoint meta, concat-mixed with the lexical hash
    # half) — measured cross-repo recall@1 0.738 vs 0.375 for hash-only
    # (.bench/crossrepo_eval.json). When no checkpoint ships (stripped
    # install), create_provider falls back down `fallbacks` to hash.
    provider: str = "ensemble"  # ensemble | encoder | hash | openai | jina | ollama | lmstudio
    model: str = "minilm-l6"
    # "byte" (default) | path to a trained BPE .json | HF dir / vocab.txt
    # ("byte" defers to the checkpoint's embedded tokenizer reference
    # when one is present — the shipped r3 checkpoint names its BPE-16k)
    tokenizer: str = "byte"
    dimension: int = 768
    batch_size: int = 256
    max_chunk_tokens: int = 512
    chunk_overlap_tokens: int = 64
    normalize: bool = True
    # base URL override for the HTTP providers (reference:
    # CODEGRAPH_OLLAMA_URL and friends, config_manager.rs:696-908)
    base_url: str = ""
    # fallback chain, tried in order when the primary is unavailable
    # (reference: HybridEmbeddingPipeline, providers.rs:120-256)
    fallbacks: List[str] = field(default_factory=lambda: ["hash"])


@dataclass
class IndexConfig:
    """Vector index layout + search knobs."""

    kind: str = "flat"  # flat | ivf | ivfpq
    metric: str = "cosine"  # cosine | dot
    dtype: str = "float32"  # float32 | bfloat16 | int8
    capacity: int = 0  # 0 = size to corpus, padded
    # IVF
    nlist: int = 4096
    nprobe: int = 64
    kmeans_iters: int = 10
    # IVF-PQ (index/ivfpq.py): m-byte residual codes + host refine store
    pq_m: int = 96
    pq_refine: str = "int8"  # none | int8 | f32
    # int8 rescore (reference BASELINE config 2: rescore top-100 in f32)
    rescore_k: int = 100


@dataclass
class SearchConfig:
    """Hybrid scoring (reference: codegraph.surql:470-472 = 0.9/0.1 mix)."""

    vector_weight: float = 0.9
    text_weight: float = 0.1
    graph_boost_weight: float = 0.1
    # weight of SearchFilters.metadata_match_score in ranking when a
    # filtered query runs (reference: search.rs:317-345 hybrid_search
    # mixes vw*score + (1-vw)*meta; here it is additive like the other
    # boost terms)
    metadata_weight: float = 0.1
    # bonus weight on a node's SECOND-best chunk score: two chunks of
    # the same node independently matching the query is stronger
    # evidence than one (the reference's chunk->parent fold keeps only
    # the max, codegraph.surql:399-418; multi-chunk corroboration is
    # the aggregation its node-mean embedding path approximated)
    multi_hit_weight: float = 0.15
    # max edge-evidence entries attached per hit (surql:481-536 joins
    # +-50 edge rows per result set; per-hit the useful tail is short)
    related_limit: int = 8
    # query-time over-retrieve multiplier (reference: search.rs:110 uses 3x)
    prefetch_multiplier: int = 3
    default_limit: int = 10
    max_limit: int = 100
    # default ON since r5: the feature reranker (passthrough stage 1 +
    # name/snippet/path/degree features stacked on retrieval scores)
    # measured net-positive on BOTH gates — rerank_eval recall@1 0.746
    # vs 0.738 retrieval-only, agent_eval tool_rerank 0.410 vs 0.407
    # tool_plain — at ~zero added latency. The r3 cross-encoder and the
    # snippet re-embedding stage remain opt-in (they degrade ranking).
    rerank: bool = True
    reranker: str = "feature"  # embedding | cross_encoder | feature | none
    # stage-1 candidate pool for the rerank pipeline (reference:
    # CODEGRAPH_RERANKING_CANDIDATES)
    rerank_candidates: int = 100
    cache_size: int = 1024
    cache_ttl_s: float = 300.0


@dataclass
class ParallelConfig:
    """Device mesh layout for sharded search / training."""

    mesh_shape: Optional[List[int]] = None  # None = all devices on one axis
    mesh_axes: List[str] = field(default_factory=lambda: ["data"])
    shard_corpus: bool = True


@dataclass
class IndexingConfig:
    """Indexer pipeline knobs (reference: IndexerConfig, indexer.rs:161-183)."""

    tier: str = "balanced"  # fast | balanced | full (reference IndexingTier)
    workers: int = 4
    batch_size: int = 256
    include_globs: List[str] = field(default_factory=list)
    exclude_globs: List[str] = field(
        default_factory=lambda: [
            "**/.git/**",
            "**/node_modules/**",
            "**/target/**",
            "**/__pycache__/**",
            "**/.venv/**",
            "**/dist/**",
            "**/build/**",
        ]
    )
    max_file_size: int = 2 * 1024 * 1024
    watch_debounce_ms: int = 400


@dataclass
class LLMConfig:
    """LLM provider for agentic tools (reference: codegraph-ai llm_factory)."""

    provider: str = "none"  # none | anthropic | openai | openai_compatible | ollama
    model: str = ""
    base_url: str = ""
    api_key_env: str = ""
    context_window: int = 128_000
    max_tokens: int = 4096
    temperature: float = 0.2
    # passed through to providers that support it (reference:
    # CODEGRAPH_REASONING_EFFORT / CODEGRAPH_USE_COMPLETIONS_API)
    reasoning_effort: str = ""
    use_completions_api: bool = False


@dataclass
class DaemonConfig:
    """Watch daemon + circuit breaker (reference: daemon/health.rs:14-184)."""

    enabled: bool = False
    auto_start: bool = False          # CODEGRAPH_DAEMON_AUTO_START
    watch_path: str = ""              # CODEGRAPH_DAEMON_WATCH_PATH
    batch_timeout_ms: int = 1000      # CODEGRAPH_DAEMON_BATCH_TIMEOUT_MS
    failure_threshold: int = 5
    open_cooldown_s: float = 30.0
    backoff_base_s: float = 1.0
    backoff_max_s: float = 60.0
    heartbeat_interval_s: float = 5.0
    heartbeat_max_missed: int = 3


@dataclass
class LatsConfig:
    """LATS tree-search knobs + per-phase LLM routing (reference:
    CODEGRAPH_LATS_* env overrides, config_manager.rs:696-908; the
    autoagents provider_router routes each LATS phase to its own
    provider/model)."""

    beam_width: int = 2           # proposals per expansion
    max_depth: int = 4
    exploration_weight: float = 1.4  # UCB c
    selection_provider: str = ""
    selection_model: str = ""
    expansion_provider: str = ""
    expansion_model: str = ""
    evaluation_provider: str = ""
    evaluation_model: str = ""
    backprop_provider: str = ""
    backprop_model: str = ""


@dataclass
class ServerConfig:
    http_host: str = "127.0.0.1"
    http_port: int = 3003
    transport: str = "stdio"  # stdio | http


@dataclass
class CodeGraphConfig:
    project_root: str = "."
    data_dir: str = ""
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    search: SearchConfig = field(default_factory=SearchConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    lats: LatsConfig = field(default_factory=LatsConfig)
    daemon: DaemonConfig = field(default_factory=DaemonConfig)
    server: ServerConfig = field(default_factory=ServerConfig)

    def resolved_data_dir(self) -> Path:
        if self.data_dir:
            return Path(self.data_dir)
        return Path(self.project_root) / ".codegraph"

    def validate(self) -> List[str]:
        """Validate with warnings, never hard-fail on tunables
        (reference: config_manager.rs:316-344)."""
        warnings: List[str] = []
        if self.embedding.dimension <= 0:
            warnings.append("embedding.dimension must be > 0; using 384")
            self.embedding.dimension = 384
        if self.index.kind not in ("flat", "ivf", "ivfpq"):
            warnings.append(f"index.kind {self.index.kind!r} unknown; using flat")
            self.index.kind = "flat"
        if self.index.metric not in ("cosine", "dot"):
            warnings.append(f"index.metric {self.index.metric!r} unknown; using cosine")
            self.index.metric = "cosine"
        if not 0.0 <= self.search.vector_weight <= 1.0:
            warnings.append("search.vector_weight out of [0,1]; using 0.9")
            self.search.vector_weight = 0.9
        if self.index.nprobe > self.index.nlist:
            warnings.append("index.nprobe > nlist; clamping")
            self.index.nprobe = self.index.nlist
        for w in warnings:
            logger.warning(w)
        return warnings


# CODEGRAPH_* env var -> dotted config path (+ type), mirroring the
# reference's env override table (config_manager.rs:696-908).
_ENV_OVERRIDES: Dict[str, str] = {
    "CODEGRAPH_EMBEDDING_PROVIDER": "embedding.provider",
    "CODEGRAPH_EMBEDDING_MODEL": "embedding.model",
    "CODEGRAPH_EMBEDDING_TOKENIZER": "embedding.tokenizer",
    "CODEGRAPH_EMBEDDING_DIMENSION": "embedding.dimension",
    "CODEGRAPH_EMBEDDING_BATCH_SIZE": "embedding.batch_size",
    "CODEGRAPH_MAX_CHUNK_TOKENS": "embedding.max_chunk_tokens",
    "CODEGRAPH_CHUNK_OVERLAP_TOKENS": "embedding.chunk_overlap_tokens",
    "CODEGRAPH_INDEX_KIND": "index.kind",
    "CODEGRAPH_INDEX_METRIC": "index.metric",
    "CODEGRAPH_INDEX_DTYPE": "index.dtype",
    "CODEGRAPH_IVF_NLIST": "index.nlist",
    "CODEGRAPH_IVF_NPROBE": "index.nprobe",
    "CODEGRAPH_RESCORE_K": "index.rescore_k",
    "CODEGRAPH_VECTOR_WEIGHT": "search.vector_weight",
    "CODEGRAPH_TEXT_WEIGHT": "search.text_weight",
    "CODEGRAPH_GRAPH_BOOST_WEIGHT": "search.graph_boost_weight",
    "CODEGRAPH_MULTI_HIT_WEIGHT": "search.multi_hit_weight",
    "CODEGRAPH_SEARCH_LIMIT": "search.default_limit",
    "CODEGRAPH_RERANK": "search.rerank",
    # reranker backend selection (embedding | cross_encoder | none);
    # the reference selects its rerank provider via env the same way
    # (JINA_ENABLE_RERANKING/model vars, config_manager.rs:730-760)
    "CODEGRAPH_RERANKER": "search.reranker",
    "CODEGRAPH_INDEX_TIER": "indexing.tier",
    "CODEGRAPH_WORKERS": "indexing.workers",
    "CODEGRAPH_BATCH_SIZE": "indexing.batch_size",
    "CODEGRAPH_LLM_PROVIDER": "llm.provider",
    "CODEGRAPH_LLM_MODEL": "llm.model",
    "CODEGRAPH_LLM_BASE_URL": "llm.base_url",
    "CODEGRAPH_CONTEXT_WINDOW": "llm.context_window",
    "CODEGRAPH_HTTP_PORT": "server.http_port",
    "CODEGRAPH_DATA_DIR": "data_dir",
    # round-3 parity sweep vs config_manager.rs:696-908
    "CODEGRAPH_MODEL": "llm.model",
    "CODEGRAPH_TEMPERATURE": "llm.temperature",
    "CODEGRAPH_REASONING_EFFORT": "llm.reasoning_effort",
    "CODEGRAPH_USE_COMPLETIONS_API": "llm.use_completions_api",
    "CODEGRAPH_LOCAL_MODEL": "embedding.model",
    "CODEGRAPH_OLLAMA_URL": "embedding.base_url",
    "CODEGRAPH_ENABLE_RERANKING": "search.rerank",
    "CODEGRAPH_RERANKING_CANDIDATES": "search.rerank_candidates",
    "CODEGRAPH_DAEMON_AUTO_START": "daemon.auto_start",
    "CODEGRAPH_DAEMON_WATCH_PATH": "daemon.watch_path",
    "CODEGRAPH_DAEMON_BATCH_TIMEOUT_MS": "daemon.batch_timeout_ms",
    "CODEGRAPH_DAEMON_DEBOUNCE_MS": "indexing.watch_debounce_ms",
    "CODEGRAPH_LATS_BEAM_WIDTH": "lats.beam_width",
    "CODEGRAPH_LATS_MAX_DEPTH": "lats.max_depth",
    "CODEGRAPH_LATS_EXPLORATION_WEIGHT": "lats.exploration_weight",
    "CODEGRAPH_LATS_SELECTION_PROVIDER": "lats.selection_provider",
    "CODEGRAPH_LATS_SELECTION_MODEL": "lats.selection_model",
    "CODEGRAPH_LATS_EXPANSION_PROVIDER": "lats.expansion_provider",
    "CODEGRAPH_LATS_EXPANSION_MODEL": "lats.expansion_model",
    "CODEGRAPH_LATS_EVALUATION_PROVIDER": "lats.evaluation_provider",
    "CODEGRAPH_LATS_EVALUATION_MODEL": "lats.evaluation_model",
    "CODEGRAPH_LATS_BACKPROP_PROVIDER": "lats.backprop_provider",
    "CODEGRAPH_LATS_BACKPROP_MODEL": "lats.backprop_model",
}


def _set_dotted(cfg: Any, dotted: str, raw: str) -> None:
    parts = dotted.split(".")
    obj = cfg
    for p in parts[:-1]:
        obj = getattr(obj, p)
    name = parts[-1]
    current = getattr(obj, name)
    value: Any
    if isinstance(current, bool):
        value = raw.strip().lower() in ("1", "true", "yes", "on")
    elif isinstance(current, int):
        value = int(raw)
    elif isinstance(current, float):
        value = float(raw)
    elif isinstance(current, list):
        value = [s.strip() for s in raw.split(",") if s.strip()]
    else:
        value = raw
    setattr(obj, name, value)


def _apply_dict(cfg: Any, data: Dict[str, Any]) -> None:
    for key, val in data.items():
        if not hasattr(cfg, key):
            logger.warning("unknown config key %r ignored", key)
            continue
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(val, dict):
            _apply_dict(current, val)
        else:
            setattr(cfg, key, val)


def load_config(
    path: Optional[str] = None,
    overrides: Optional[Dict[str, Any]] = None,
    apply_env: bool = True,
) -> CodeGraphConfig:
    """Load config with precedence defaults < TOML < env < overrides
    (same precedence as the reference: config_manager.rs:580+)."""
    cfg = CodeGraphConfig()
    toml_path = Path(path) if path else CONFIG_PATH
    if toml_path.exists():
        try:
            import tomllib

            with open(toml_path, "rb") as f:
                _apply_dict(cfg, tomllib.load(f))
        except Exception as exc:  # pragma: no cover - defensive
            logger.warning("failed to load %s: %s", toml_path, exc)
    if apply_env:
        for env_name, dotted in _ENV_OVERRIDES.items():
            raw = os.environ.get(env_name)
            if raw is None:
                continue
            try:
                _set_dotted(cfg, dotted, raw)
            except (ValueError, AttributeError) as exc:
                logger.warning("invalid %s=%r: %s", env_name, raw, exc)
    if overrides:
        _apply_dict(cfg, overrides)
    cfg.validate()
    return cfg


__all__ = [
    "CodeGraphConfig",
    "EmbeddingConfig",
    "IndexConfig",
    "SearchConfig",
    "ParallelConfig",
    "IndexingConfig",
    "LLMConfig",
    "DaemonConfig",
    "ServerConfig",
    "load_config",
]

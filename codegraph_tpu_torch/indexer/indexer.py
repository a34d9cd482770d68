"""Port of `codegraph_tpu/indexer/indexer.py` for `index.kind = "flat"`
(float32 or bfloat16 rows); the other index tiers raise NotImplementedError.
Flat snapshots use the same .npy + manifest format as the JAX package, so
either package loads the other's.

ProjectIndexer: the full build pipeline.

Re-implements the reference's `ProjectIndexer::index_project` call stack
(SURVEY.md section 3.1; indexer.rs:860): change detection -> parallel
parse -> deterministic ids -> edge resolution -> chunk plan -> batched
embed -> vector index + BM25 -> metadata persist -> verify counts.
Differences are deliberate TPU re-design: embedding runs on-chip through
the provider (no HTTP unless configured), vectors land in an HBM-resident
index rather than SurrealDB, and incremental updates tombstone index rows
(delete-then-insert with deterministic ids, exactly the reference's
semantics at indexer.rs:3186-3254).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from codegraph_tpu_torch.core.config import CodeGraphConfig
from codegraph_tpu_torch.core.types import CodeChunk, CodeNode
from codegraph_tpu_torch.graph.store import GraphStore
from codegraph_tpu_torch.index.flat import FlatIndex
from codegraph_tpu_torch.indexer.resolve import EdgeResolver
from codegraph_tpu_torch.models.providers import create_provider
from codegraph_tpu_torch.parser.chunker import ChunkerConfig, build_chunk_plan
from codegraph_tpu_torch.parser.parser import SourceParser
from codegraph_tpu_torch.search.bm25 import BM25Index
from codegraph_tpu_torch.search.hybrid import HybridSearch

logger = logging.getLogger("codegraph_tpu_torch.indexer")


@dataclass
class IndexStats:
    """Per-stage counters (reference: IndexStats, indexer.rs:4633-4679)."""

    files_total: int = 0
    files_parsed: int = 0
    files_unchanged: int = 0
    files_deleted: int = 0
    nodes: int = 0
    nodes_reused: int = 0  # symbol-level incremental: unchanged symbols kept
    edges_total: int = 0
    edges_resolved_exact: int = 0
    edges_resolved_semantic: int = 0
    edges_unresolved: int = 0
    edges_external: int = 0  # std/dependency targets (not project symbols)
    chunks: int = 0
    embedded: int = 0
    analyzer_counters: Dict[str, int] = field(default_factory=dict)
    stage_seconds: Dict[str, float] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        d = self.__dict__.copy()
        d["stage_seconds"] = {k: round(v, 3) for k, v in self.stage_seconds.items()}
        return d


#: index configurations of the JAX package that this port does not run
#: yet, with the ROADMAP item that ports them
UNPORTED_INDEXES = {
    "ivf": "ROADMAP item 10 (kmeans + IVFIndex)",
    "ivfpq": "ROADMAP item 11 (PQ/OPQ + IVFPQIndex, kernel K8)",
    "int8": "ROADMAP item 7 (Int8FlatIndex, kernels K5/K6)",
}


def _make_index(cfg: CodeGraphConfig, dim: Optional[int] = None, device="cuda"):
    # dim: the PROVIDER's actual output width when it differs from the
    # configured one (the index follows the provider, not the config)
    icfg = cfg.index
    dim = int(dim) if dim else cfg.embedding.dimension
    if icfg.kind in UNPORTED_INDEXES:
        raise NotImplementedError(
            f"index.kind {icfg.kind!r} is not ported yet: "
            f"{UNPORTED_INDEXES[icfg.kind]}")
    if icfg.dtype in UNPORTED_INDEXES:
        raise NotImplementedError(
            f"index.dtype {icfg.dtype!r} is not ported yet: "
            f"{UNPORTED_INDEXES[icfg.dtype]}")
    return FlatIndex(dim, metric=icfg.metric, dtype=icfg.dtype, device=device)


class ProjectIndexer:
    """End-to-end indexer bound to one project directory."""

    def __init__(
        self,
        config: Optional[CodeGraphConfig] = None,
        provider=None,
        store: Optional[GraphStore] = None,
        index=None,
        device="cuda",
    ):
        self.config = config or CodeGraphConfig()
        self.device = device
        self.provider = provider or create_provider(self.config)
        self.store = store or GraphStore()
        self.index = index if index is not None else _make_index(
            self.config, getattr(self.provider, "dimension", None), device)
        self.bm25 = BM25Index()
        self.resolver = EdgeResolver(self.provider)
        self.search = HybridSearch(
            self.store, self.index, self.provider, self.bm25, self.config.search
        )
        self.chunker_cfg = ChunkerConfig(
            max_tokens=self.config.embedding.max_chunk_tokens,
            overlap_tokens=self.config.embedding.chunk_overlap_tokens,
        )

    # -- full / incremental build -----------------------------------------


    def _count_tokens(self):
        """Chunk budgets use the embedding provider's tokenizer when it
        has one (subword budgets, prep/chunker.rs:12-70 semantics);
        falls back to byte counting."""
        tok = getattr(self.provider, "tokenizer", None)
        return getattr(tok, "count_tokens", None)

    def index_project(
        self, root: Optional[str] = None, force: bool = False
    ) -> IndexStats:
        root = root or self.config.project_root
        stats = IndexStats()
        t_all = time.perf_counter()

        parser = SourceParser(
            project=os.path.abspath(root),
            workers=self.config.indexing.workers,
        )

        t0 = time.perf_counter()
        parses, pstats = parser.parse_directory(
            root,
            include_globs=self.config.indexing.include_globs or None,
            exclude_globs=self.config.indexing.exclude_globs,
            max_file_size=self.config.indexing.max_file_size,
        )
        stats.stage_seconds["parse"] = time.perf_counter() - t0
        stats.files_total = pstats.files
        from codegraph_tpu_torch.utils.progress import ProgressReporter

        _pp = ProgressReporter().stage("parse", pstats.files, "files")
        _pp.t0, _pp.n = t0, pstats.files
        _pp.done()

        # change detection (checkpoint/resume; indexer.rs:3186-3254)
        current = {fp.path: fp.digest for fp in parses}
        if force:
            added = list(current.keys())
            modified, deleted, unchanged = [], [], []
            self._reset_state()
        else:
            added, modified, deleted, unchanged = self.store.detect_file_changes(
                current
            )
        stats.files_unchanged = len(unchanged)
        stats.files_deleted = len(deleted)

        t0 = time.perf_counter()
        for path in deleted + modified:
            node_rows, chunk_rows = self.store.delete_file_data(path)
            self._tombstone_chunks(chunk_rows)
            # BM25 docs are keyed by node row: without removal, dead
            # rows keep crowding the prefetch budget and postings grow
            # without bound across incremental updates
            for r in node_rows:
                self.bm25.remove(r)
        stats.stage_seconds["delete"] = time.perf_counter() - t0

        to_ingest = [fp for fp in parses if fp.path in set(added) | set(modified)]
        stats.files_parsed = len(to_ingest)

        # nodes + edges
        t0 = time.perf_counter()
        new_nodes: List[CodeNode] = []
        new_edges = []
        for fp in to_ingest:
            new_nodes.extend(fp.result.nodes)
            new_edges.extend(fp.result.edges)
        stats.stage_seconds["nodes"] = time.perf_counter() - t0

        # analyzers per tier (reference: indexer.rs:977-1388)
        t0 = time.perf_counter()
        if new_nodes:
            from codegraph_tpu_torch.indexer.analyzers import (
                AnalyzerSettings,
                run_analyzers,
            )

            settings = AnalyzerSettings.for_tier(self.config.indexing.tier)
            lsp_files = None
            if settings.lsp:
                # the external-LSP analyzer needs path -> (language,
                # text) for didOpen; read only when the tier enables it
                lsp_files = {}
                for fp in to_ingest:
                    try:
                        with open(fp.path, encoding="utf-8",
                                  errors="replace") as f:
                            lsp_files[fp.path] = (fp.language, f.read())
                    except OSError:
                        continue
            aout = run_analyzers(
                project=os.path.abspath(root), root=root,
                nodes=new_nodes, edges=new_edges,
                settings=settings, files=lsp_files,
            )
            new_nodes.extend(aout.nodes)
            new_edges.extend(aout.edges)
            stats.analyzer_counters = aout.counters
        self.store.upsert_nodes(new_nodes)
        stats.nodes = len(new_nodes)
        stats.stage_seconds["analyze"] = time.perf_counter() - t0

        # edge resolution against ALL nodes (cross-file)
        t0 = time.perf_counter()
        all_nodes = list(self.store.nodes.values())
        # build-manifest dependency names are external roots: a bare
        # `serde_json!`-style macro or `use criterion::...` classifies
        # against the project's own declared dependency set
        # (BuildContextAnalyzer parses the manifests)
        from codegraph_tpu_torch.core.types import EdgeType as _ET
        ext_roots = set()
        for e in new_edges:
            if e.edge_type == _ET.DEPENDS_ON and not e.resolved:
                ext_roots.add(e.dst)
                ext_roots.add(e.dst.replace("-", "_"))
        unresolved, n_exact, n_sem, n_ext = self.resolver.resolve(
            new_edges, all_nodes, external_roots=ext_roots)
        resolved_edges = [e for e in new_edges if e.resolved]
        self.store.add_edges(resolved_edges)
        stats.edges_total = len(new_edges)
        stats.edges_resolved_exact = n_exact
        stats.edges_resolved_semantic = n_sem
        stats.edges_unresolved = len(unresolved)
        stats.edges_external = n_ext
        stats.stage_seconds["resolve"] = time.perf_counter() - t0

        # chunk + embed + index (the TPU hot loop, indexer.rs:1603-1685)
        t0 = time.perf_counter()
        plan = build_chunk_plan(new_nodes, self.chunker_cfg,
                                count_tokens=self._count_tokens())
        stats.chunks = len(plan.chunks)
        stats.stage_seconds["chunk"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        self._embed_and_index_with_progress(plan.chunks)
        stats.embedded = len(plan.chunks)
        stats.stage_seconds["embed"] = time.perf_counter() - t0

        # BM25 over node name+content
        t0 = time.perf_counter()
        for node in new_nodes:
            self.bm25.add(node.row, f"{node.name} {node.content}")
        stats.stage_seconds["bm25"] = time.perf_counter() - t0

        # metadata + verify
        for fp in to_ingest:
            self.store.record_file(fp.path, fp.digest)
        self.search.invalidate()
        self._verify_counts(stats)
        stats.stage_seconds["total"] = time.perf_counter() - t_all
        logger.info("index_project done: %s", stats.to_dict())
        return stats

    def _reset_state(self) -> None:
        self.store = GraphStore()
        self.index = _make_index(self.config,
                                 getattr(self.provider, "dimension", None),
                                 self.device)
        self.bm25 = BM25Index()
        self.search = HybridSearch(
            self.store, self.index, self.provider, self.bm25, self.config.search
        )

    def _embed_and_index_with_progress(
        self, chunks: Sequence[CodeChunk]
    ) -> None:
        """Embed in slices with a live rate/ETA line (reference:
        indexer.rs:4107 indicatif batch progress)."""
        from codegraph_tpu_torch.utils.progress import ProgressReporter

        if not chunks:
            return
        bs = max(int(self.config.indexing.batch_size), 256) * 4
        first = min(len(chunks), bs)
        prog = ProgressReporter().stage("embed", len(chunks), "chunks")
        done = 0
        for lo in [0] + list(range(first, len(chunks), bs)):
            hi = first if lo == 0 else min(lo + bs, len(chunks))
            self._embed_and_index(chunks[lo:hi])
            done = hi
            prog.update(done)
        prog.done()

    def _embed_and_index(self, chunks: Sequence[CodeChunk]) -> None:
        if not chunks:
            return
        rows = self.store.upsert_chunks(list(chunks))
        texts = [c.text for c in chunks]
        embs = self.provider.embed_texts_device(texts)
        got = self.index.add(embs)
        # rows from the store must match index rows; both are append-only
        if list(got) != list(rows):
            logger.warning(
                "row drift: store rows %s... vs index rows %s...",
                rows[:3], got[:3],
            )

    def _tombstone_chunks(self, chunk_rows: Sequence[int]) -> None:
        if chunk_rows:
            self.index.delete(np.asarray(chunk_rows, np.int64))

    def _verify_counts(self, stats: IndexStats) -> None:
        """Count verification (reference: indexer.rs:3540,3596)."""
        live_chunks = sum(1 for c in self.store.row_chunks if c is not None)
        if len(self.index) != live_chunks:
            logger.warning(
                "count mismatch: index has %d live rows, store has %d chunks",
                len(self.index), live_chunks,
            )

    # -- single-file incremental (watch mode; indexer.rs:4117) -------------

    def index_single_file(self, path: str) -> Optional[IndexStats]:
        """Symbol-level incremental re-index of one file (watch mode).

        Reference: indexer.rs:4117 index_single_file re-embeds the whole
        file; codegraph-core/src/watch/mod.rs:46,772 detects which
        SYMBOLS changed. Here both are combined: deterministic node ids
        (project/file/name/type/start_line) pin symbol identity, so a
        re-parse identifies unchanged symbols by id + content equality —
        their chunks keep their index rows and are NOT re-embedded; only
        changed/new symbols' chunks go through the encoder. A one-line
        edit inside one function re-embeds only that function.
        """
        parser = SourceParser(project=os.path.abspath(self.config.project_root))
        fp = parser.parse_file(path)
        if fp is None:
            return None
        stats = IndexStats(files_total=1, files_parsed=1)

        # unchanged symbols: same deterministic id AND identical content
        old_ids = set(self.store.file_nodes.get(path, []))
        new_by_id = {n.id: n for n in fp.result.nodes}
        keep = {
            nid for nid in old_ids
            if nid in new_by_id
            and self.store.nodes.get(nid) is not None
            and self.store.nodes[nid].content == new_by_id[nid].content
        }
        node_rows, chunk_rows = self.store.delete_file_data(
            path, keep_node_ids=keep
        )
        self._tombstone_chunks(chunk_rows)
        for r in node_rows:
            self.bm25.remove(r)
        self.store.upsert_nodes(fp.result.nodes)
        all_nodes = list(self.store.nodes.values())
        unresolved, n_exact, n_sem, n_ext = self.resolver.resolve(
            fp.result.edges, all_nodes
        )
        self.store.add_edges([e for e in fp.result.edges if e.resolved])
        changed_nodes = [n for n in fp.result.nodes if n.id not in keep]
        plan = build_chunk_plan(changed_nodes, self.chunker_cfg,
                                count_tokens=self._count_tokens())
        self._embed_and_index(plan.chunks)
        for node in changed_nodes:
            self.bm25.add(node.row, f"{node.name} {node.content}")
        self.store.record_file(path, fp.digest)
        self.search.invalidate()
        stats.nodes = len(fp.result.nodes)
        stats.nodes_reused = len(keep)
        stats.chunks = len(plan.chunks)
        stats.edges_total = len(fp.result.edges)
        stats.edges_resolved_exact = n_exact
        stats.edges_resolved_semantic = n_sem
        stats.edges_unresolved = len(unresolved)
        stats.edges_external = n_ext
        return stats

    def delete_file(self, path: str) -> None:
        node_rows, chunk_rows = self.store.delete_file_data(path)
        self._tombstone_chunks(chunk_rows)
        for r in node_rows:
            self.bm25.remove(r)
        self.search.invalidate()

    # -- persistence -------------------------------------------------------

    def save(self, directory: Optional[str] = None) -> str:
        directory = directory or str(self.config.resolved_data_dir())
        os.makedirs(directory, exist_ok=True)
        self.store.save(directory)
        self._save_index(directory)
        # zero-deserialize serving copy of the graph (mmap columnar,
        # graph/archive.py): read-only consumers (MCP server analytics)
        # open this in O(1) instead of parsing the jsonl snapshot
        from codegraph_tpu_torch.graph.archive import write_graph_archive

        write_graph_archive(self.store,
                            os.path.join(directory, "graph_archive"))
        return directory

    def _save_index(self, directory: str) -> None:
        """Persist via the mmap snapshot format (index/snapshot.py); rows
        are saved as f32 whatever the storage dtype, as the JAX package
        does."""
        from codegraph_tpu_torch.index.snapshot import save_arrays

        x, bias = self.index.arrays()
        if x is None:
            return
        meta = {"n_rows": self.index.n_rows, "n_live": self.index.n_live,
                "dim": self.index.dim, "kind": "flat"}
        save_arrays(directory, {
            "x": x.float().cpu().numpy(), "bias": bias.cpu().numpy(),
        }, meta)

    def load(self, directory: Optional[str] = None) -> None:
        directory = directory or str(self.config.resolved_data_dir())
        from codegraph_tpu_torch.index.snapshot import MANIFEST, load_arrays

        self.store = GraphStore.load(directory)
        if os.path.exists(os.path.join(directory, MANIFEST)):
            arrays, meta = load_arrays(directory)
            kind = meta.get("kind")
            if kind in UNPORTED_INDEXES:
                raise NotImplementedError(
                    f"snapshot index kind {kind!r} is not ported yet: "
                    f"{UNPORTED_INDEXES[kind]}")
            if kind == "flat":
                self.index.load_arrays(
                    arrays["x"], arrays["bias"], int(meta["n_rows"]),
                    int(meta["n_live"]),
                )
        # rebuild BM25 from the store (derived state)
        self.bm25 = BM25Index()
        for node in self.store.nodes.values():
            self.bm25.add(node.row, f"{node.name} {node.content}")
        self.search = HybridSearch(
            self.store, self.index, self.provider, self.bm25, self.config.search
        )


__all__ = ["ProjectIndexer", "IndexStats"]

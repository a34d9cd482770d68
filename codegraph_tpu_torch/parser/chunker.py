"""Copy of `codegraph_tpu/parser/chunker.py` for the PyTorch port.

Tokenizer-aware semantic chunking with overlap.

Reference: crates/codegraph-vector/src/prep/chunker.rs:12-374
(ChunkerConfig max tokens + 64-token overlap + smart split on line
boundaries; ChunkPlan{chunks, metas, stats}). The long-context strategy
of the whole system is chunking, not attention parallelism (SURVEY.md
section 5): node text splits into token-budgeted chunks; chunk
embeddings are the retrieval unit, with parent-node links for enrich.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

from codegraph_tpu_torch.core.types import CodeChunk, CodeNode


@dataclass
class ChunkerConfig:
    max_tokens: int = 512
    overlap_tokens: int = 64  # chunker.rs default 64-token overlap
    min_chunk_tokens: int = 16
    smart_split: bool = True  # prefer line boundaries


@dataclass
class ChunkStats:
    n_nodes: int = 0
    n_chunks: int = 0
    n_truncated: int = 0
    total_tokens: int = 0


@dataclass
class ChunkPlan:
    chunks: List[CodeChunk] = field(default_factory=list)
    stats: ChunkStats = field(default_factory=ChunkStats)


def _default_count(text: str) -> int:
    # byte tokenizer: tokens == bytes (models/tokenizer.py)
    return len(text.encode("utf-8", errors="replace"))


def split_text(
    text: str,
    max_tokens: int,
    overlap: int,
    count: Callable[[str], int],
    smart: bool = True,
) -> List[str]:
    """Split into <= max_tokens pieces with `overlap` tokens of context
    carried between consecutive chunks; prefers line boundaries."""
    if count(text) <= max_tokens:
        return [text] if text.strip() else []
    lines = text.splitlines(keepends=True) if smart else [text]
    # fall back to char slicing for single huge lines
    pieces: List[str] = []
    for ln in lines:
        if count(ln) > max_tokens:
            step = max(max_tokens // 2, 1)
            pieces.extend(ln[i : i + step] for i in range(0, len(ln), step))
        else:
            pieces.append(ln)

    chunks: List[str] = []
    cur: List[str] = []
    cur_tok = 0
    for piece in pieces:
        t = count(piece)
        if cur and cur_tok + t > max_tokens:
            chunks.append("".join(cur))
            # carry overlap: keep trailing pieces up to `overlap` tokens
            keep: List[str] = []
            keep_tok = 0
            for p in reversed(cur):
                pt = count(p)
                if keep_tok + pt > overlap:
                    break
                keep.insert(0, p)
                keep_tok += pt
            cur, cur_tok = keep, keep_tok
        cur.append(piece)
        cur_tok += t
    if cur and "".join(cur).strip():
        chunks.append("".join(cur))
    return chunks


def prepare_node_text(node: CodeNode) -> str:
    """Text fed to the embedder: header line + content (reference:
    prepare_node_text, indexer.rs:4540 prepends name/kind/path context)."""
    header = f"{node.language.value} {node.node_type.value} {node.name} ({node.location.file_path})"
    return f"{header}\n{node.content}" if node.content else header


def build_chunk_plan(
    nodes: Sequence[CodeNode],
    config: Optional[ChunkerConfig] = None,
    count_tokens: Optional[Callable[[str], int]] = None,
) -> ChunkPlan:
    """Nodes -> token-budgeted chunks (reference: build_chunk_plan used by
    the indexer at indexer.rs:1395-1437)."""
    cfg = config or ChunkerConfig()
    count = count_tokens or _default_count
    plan = ChunkPlan()
    for node in nodes:
        text = prepare_node_text(node)
        parts = split_text(
            text, cfg.max_tokens, cfg.overlap_tokens, count, cfg.smart_split
        )
        if not parts:
            continue
        plan.stats.n_nodes += 1
        if len(parts) > 1:
            plan.stats.n_truncated += 1
        for i, part in enumerate(parts):
            plan.chunks.append(CodeChunk.make(node.id, part, i, len(parts)))
            plan.stats.total_tokens += count(part)
        plan.stats.n_chunks = len(plan.chunks)
    return plan


__all__ = [
    "ChunkerConfig",
    "ChunkPlan",
    "ChunkStats",
    "split_text",
    "prepare_node_text",
    "build_chunk_plan",
]

"""Copy of `codegraph_tpu/parser/parser.py` for the PyTorch port.

Parallel directory parsing.

Reference: crates/codegraph-parser/src/parser.rs:44-1031
(TreeSitterParser::parse_directory_parallel — concurrency-capped,
largest-file-first, per-file caching; parse_file_with_edges unified
node+edge extraction). Here parsing is pure-Python host work fanned out
over a thread pool (extraction is regex/ast-bound, and files are I/O
bound, so threads suffice); the per-file content-hash cache skips
re-extraction of unchanged files.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from codegraph_tpu_torch.core.types import Language, content_hash, language_for_path
from codegraph_tpu_torch.parser.extractors import ExtractionResult, extract_file
from codegraph_tpu_torch.parser.files import collect_source_files, read_text

logger = logging.getLogger("codegraph_tpu_torch.parser")


@dataclass
class ParseStats:
    files: int = 0
    parsed: int = 0
    cached: int = 0
    failed: int = 0
    nodes: int = 0
    edges: int = 0
    lines: int = 0
    seconds: float = 0.0

    @property
    def lines_per_second(self) -> float:
        return self.lines / self.seconds if self.seconds > 0 else 0.0


@dataclass
class FileParse:
    path: str
    digest: str
    language: Language
    result: ExtractionResult
    n_lines: int


class SourceParser:
    """Directory/file parser with a content-hash cache
    (parser.rs:767-776 per-file caching)."""

    def __init__(self, project: str, workers: int = 4):
        self.project = project
        self.workers = max(1, int(workers))
        self._cache: Dict[str, FileParse] = {}  # digest -> parse

    def parse_file(self, path: str, text: Optional[str] = None) -> Optional[FileParse]:
        language = language_for_path(path)
        if language is None:
            return None
        if text is None:
            try:
                text = read_text(path)
            except OSError as exc:
                logger.warning("read failed %s: %s", path, exc)
                return None
        digest = content_hash(text)
        cached = self._cache.get(digest)
        if cached is not None and cached.path == path:
            return cached
        result = extract_file(self.project, path, text, language)
        fp = FileParse(
            path=path, digest=digest, language=language, result=result,
            n_lines=text.count("\n") + 1,
        )
        self._cache[digest] = fp
        return fp

    def parse_directory(
        self,
        root: str,
        include_globs: Optional[Sequence[str]] = None,
        exclude_globs: Optional[Sequence[str]] = None,
        max_file_size: int = 2 * 1024 * 1024,
    ) -> Tuple[List[FileParse], ParseStats]:
        """Parse every recognized source file under root, largest first,
        fanned over the worker pool."""
        t0 = time.perf_counter()
        files = collect_source_files(
            root, include_globs, exclude_globs, max_file_size
        )
        stats = ParseStats(files=len(files))
        out: List[FileParse] = []
        with cf.ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures = {pool.submit(self.parse_file, p): p for p, _ in files}
            for fut in cf.as_completed(futures):
                try:
                    fp = fut.result()
                except Exception as exc:
                    logger.warning("parse failed %s: %s", futures[fut], exc)
                    stats.failed += 1
                    continue
                if fp is None:
                    stats.failed += 1
                    continue
                out.append(fp)
                stats.parsed += 1
                stats.nodes += len(fp.result.nodes)
                stats.edges += len(fp.result.edges)
                stats.lines += fp.n_lines
        stats.seconds = time.perf_counter() - t0
        logger.info(
            "parsed %d/%d files, %d nodes, %d edges, %.0f lines/s",
            stats.parsed, stats.files, stats.nodes, stats.edges,
            stats.lines_per_second,
        )
        return out, stats


__all__ = ["SourceParser", "FileParse", "ParseStats"]

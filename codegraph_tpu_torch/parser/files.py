"""Copy of `codegraph_tpu/parser/files.py` for the PyTorch port.

Source file collection: gitignore-aware walk, globs, size-sorted.

Reference: crates/codegraph-parser/src/file_collect.rs:29-266
(gitignore-aware walk, include/exclude, size-sorted) and parser.rs:105-107
(largest-file-first scheduling so the slowest parses start first).
"""

from __future__ import annotations

import fnmatch
import os
from typing import List, Optional, Sequence, Tuple

from codegraph_tpu_torch.core.types import EXTENSION_LANGUAGES

DEFAULT_EXCLUDES = [
    ".git", "node_modules", "target", "__pycache__", ".venv", "venv",
    "dist", "build", ".idea", ".vscode", ".codegraph",
]


def _load_gitignore(root: str) -> List[str]:
    patterns: List[str] = []
    gi = os.path.join(root, ".gitignore")
    if os.path.exists(gi):
        try:
            with open(gi, encoding="utf-8", errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith("#"):
                        patterns.append(line.rstrip("/"))
        except OSError:
            pass
    return patterns


def _matches_any(rel: str, name: str, patterns: Sequence[str]) -> bool:
    for pat in patterns:
        p = pat.lstrip("/")
        if fnmatch.fnmatch(name, p) or fnmatch.fnmatch(rel, p) or fnmatch.fnmatch(
            rel, p + "/*"
        ):
            return True
    return False


def collect_source_files(
    root: str,
    include_globs: Optional[Sequence[str]] = None,
    exclude_globs: Optional[Sequence[str]] = None,
    max_file_size: int = 2 * 1024 * 1024,
    largest_first: bool = True,
) -> List[Tuple[str, int]]:
    """Walk `root`, returning [(path, size)] of recognized source files.

    Honors .gitignore at the root, skips the default noise dirs, applies
    include/exclude globs against root-relative paths, drops files over
    max_file_size, and sorts largest-first (parser.rs:105 scheduling).
    """
    root = os.path.abspath(root)
    gitignore = _load_gitignore(root)
    excludes = list(exclude_globs or [])
    out: List[Tuple[str, int]] = []
    for dirpath, dirnames, filenames in os.walk(root):
        rel_dir = os.path.relpath(dirpath, root)
        rel_dir = "" if rel_dir == "." else rel_dir
        dirnames[:] = [
            d for d in dirnames
            if d not in DEFAULT_EXCLUDES
            and not d.startswith(".")
            and not _matches_any(os.path.join(rel_dir, d), d, gitignore)
            and not _matches_any(os.path.join(rel_dir, d), d, excludes)
        ]
        for name in filenames:
            _, ext = os.path.splitext(name)
            if ext.lower() not in EXTENSION_LANGUAGES:
                continue
            rel = os.path.join(rel_dir, name) if rel_dir else name
            if _matches_any(rel, name, gitignore) or _matches_any(rel, name, excludes):
                continue
            if include_globs and not _matches_any(rel, name, include_globs):
                continue
            path = os.path.join(dirpath, name)
            try:
                size = os.path.getsize(path)
            except OSError:
                continue
            if size > max_file_size or size == 0:
                continue
            out.append((path, size))
    if largest_first:
        out.sort(key=lambda t: -t[1])
    return out


def read_text(path: str) -> str:
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


__all__ = ["collect_source_files", "read_text", "DEFAULT_EXCLUDES"]

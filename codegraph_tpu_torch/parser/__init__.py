"""Copy of `codegraph_tpu/parser/__init__.py` for the PyTorch port.

Host-side source parsing + chunking.

Capability parity with the reference's parser crate
(crates/codegraph-parser: TreeSitterParser over 13 tree-sitter grammars,
FastML pattern/symbol enhancement, gitignore-aware file collection,
chunker, complexity, polling-free watcher). This environment has no
tree-sitter runtime, so extraction is exact-AST for Python (stdlib `ast`)
and pattern-based for the other 12 languages (the reference's own FastML
layer, src/fast_ml/pattern_matcher.rs:29, is the precedent for
regex-grade extraction); the extractor interface is grammar-agnostic so
a tree-sitter C binding can slot in behind it.
"""

from codegraph_tpu_torch.parser.files import collect_source_files
from codegraph_tpu_torch.parser.extractors import ExtractionResult, extract_file
from codegraph_tpu_torch.parser.parser import SourceParser
from codegraph_tpu_torch.parser.chunker import ChunkerConfig, build_chunk_plan
from codegraph_tpu_torch.parser.watcher import FileWatcher

__all__ = [
    "collect_source_files",
    "ExtractionResult",
    "extract_file",
    "SourceParser",
    "ChunkerConfig",
    "build_chunk_plan",
    "FileWatcher",
]

"""Copy of `codegraph_tpu/ml/features.py` for the PyTorch port (it reads the port's
`core.types` and `search.bm25`).

Hand-crafted code features.

Reference: crates/codegraph-vector/src/ml/features.rs:14-503 — syntactic
/ semantic / complexity / dependency feature groups (:44-111) used for
ranking models and analytics.
"""

from __future__ import annotations

import math
import re
from typing import Dict

from codegraph_tpu_torch.core.types import CodeNode
from codegraph_tpu_torch.search.bm25 import tokenize

_CONTROL_RE = re.compile(r"\b(if|for|while|match|switch|case|try|catch|except)\b")
_CALL_RE = re.compile(r"\b\w+\s*\(")
_COMMENT_RE = re.compile(r"(#|//|/\*|\"\"\")")


def extract_code_features(node: CodeNode) -> Dict[str, float]:
    """Feature vector for a code node (syntactic/semantic/complexity/
    dependency groups, features.rs:44-111)."""
    text = node.content or ""
    lines = text.splitlines() or [""]
    tokens = tokenize(text)
    n_lines = len(lines)
    return {
        # syntactic
        "n_lines": float(n_lines),
        "n_tokens": float(len(tokens)),
        "avg_line_len": float(sum(map(len, lines)) / n_lines),
        "max_indent": float(max(
            (len(l) - len(l.lstrip())) for l in lines
        ) if lines else 0),
        "comment_density": float(
            sum(1 for l in lines if _COMMENT_RE.search(l)) / n_lines
        ),
        # semantic
        "name_len": float(len(node.name)),
        "name_words": float(len(tokenize(node.name))),
        "vocab_richness": float(len(set(tokens)) / max(len(tokens), 1)),
        "log_token_entropy": _token_entropy(tokens),
        # complexity
        "cyclomatic": float(node.complexity),
        "control_density": float(len(_CONTROL_RE.findall(text)) / n_lines),
        "call_count": float(len(_CALL_RE.findall(text))),
        # dependency (filled from graph metadata when present)
        "references": float(node.metadata.get("references", 0)),
        "exported": 1.0 if node.metadata.get("exported") else 0.0,
    }


def _token_entropy(tokens) -> float:
    if not tokens:
        return 0.0
    counts: Dict[str, int] = {}
    for t in tokens:
        counts[t] = counts.get(t, 0) + 1
    n = len(tokens)
    return float(-sum(c / n * math.log2(c / n) for c in counts.values()))


__all__ = ["extract_code_features"]

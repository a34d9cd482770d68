"""Copy of `codegraph_tpu/parser/complexity.py` for the PyTorch port.

Cyclomatic complexity = 1 + decision points.

Reference: crates/codegraph-parser/src/complexity.rs:10-218 (AST decision
point counting). Without a universal AST here, decision points count via
keyword/operator occurrences — the same quantity for straight-line vs
branchy code, off-by-small for pathological strings/comments.
"""

from __future__ import annotations

import re

_DECISION_RE = re.compile(
    r"\b(if|elif|else if|for|while|case|when|catch|except|rescue|guard)\b"
    r"|&&|\|\||\?\?|\s\?\s"
)


def cyclomatic_complexity(body: str) -> int:
    return 1 + len(_DECISION_RE.findall(body))


__all__ = ["cyclomatic_complexity"]

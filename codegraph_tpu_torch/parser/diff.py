"""Copy of `codegraph_tpu/parser/diff.py` for the PyTorch port.

Diff-based incremental reparse.

Reference: crates/codegraph-parser/src/diff.rs:61-693 —
parse_incremental (:74) reparses only the changed byte ranges and
reports affected nodes. Without tree-sitter's incremental tree edit,
the re-design diffs at line granularity: unchanged top-level spans keep
their previous nodes (deterministic ids make them identical), only
nodes overlapping changed line ranges re-extract, and the affected-node
set feeds the impact propagation.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass, field
from typing import List, Sequence, Set

from codegraph_tpu_torch.core.types import Language
from codegraph_tpu_torch.parser.extractors import ExtractionResult, extract_file


@dataclass
class LineRange:
    start: int  # 1-based inclusive
    end: int

    def overlaps(self, other: "LineRange") -> bool:
        return self.start <= other.end and other.start <= self.end


@dataclass
class IncrementalParse:
    result: ExtractionResult
    changed_ranges: List[LineRange]
    affected_node_ids: Set[str]          # old nodes invalidated
    reused_node_ids: Set[str]            # old nodes carried over unchanged
    new_node_ids: Set[str]


def changed_line_ranges(old_text: str, new_text: str) -> List[LineRange]:
    """Line ranges (in the NEW text) that differ, merged when adjacent."""
    sm = difflib.SequenceMatcher(
        a=old_text.splitlines(), b=new_text.splitlines(), autojunk=False
    )
    ranges: List[LineRange] = []
    for tag, i1, i2, j1, j2 in sm.get_opcodes():
        if tag == "equal":
            continue
        start = j1 + 1
        end = max(j2, j1 + 1)
        if ranges and start <= ranges[-1].end + 2:
            ranges[-1].end = max(ranges[-1].end, end)
        else:
            ranges.append(LineRange(start, end))
    return ranges


class DiffBasedParser:
    """Reparse with old-result reuse (diff.rs parse_incremental)."""

    def parse_incremental(
        self,
        project: str,
        path: str,
        old_text: str,
        new_text: str,
        old_result: ExtractionResult,
        language: Language,
    ) -> IncrementalParse:
        ranges = changed_line_ranges(old_text, new_text)
        new_result = extract_file(project, path, new_text, language)
        new_ids = {n.id for n in new_result.nodes}
        old_ids = {n.id for n in old_result.nodes}
        # deterministic ids: a node whose identity fields (name, type,
        # start line) are untouched keeps its id -> "reused"
        reused = old_ids & new_ids
        affected = old_ids - new_ids
        created = new_ids - old_ids
        # nodes overlapping a changed range are affected even if the id
        # survived (content changed in place)
        if ranges:
            for node in new_result.nodes:
                span = LineRange(node.location.start_line,
                                 max(node.location.end_line,
                                     node.location.start_line))
                if node.id in reused and any(span.overlaps(r) for r in ranges):
                    reused.discard(node.id)
                    affected.add(node.id)
                    created.add(node.id)
        return IncrementalParse(
            result=new_result,
            changed_ranges=ranges,
            affected_node_ids=affected,
            reused_node_ids=reused,
            new_node_ids=created,
        )


__all__ = [
    "DiffBasedParser",
    "IncrementalParse",
    "LineRange",
    "changed_line_ranges",
]

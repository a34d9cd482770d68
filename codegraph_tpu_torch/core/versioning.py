"""Copy of `codegraph_tpu/core/versioning.py` for the PyTorch port.

Node/graph version tracking with copy-on-write history.

Reference: crates/codegraph-core/src/versioning.rs (279 LoC) — versioned
records with history, diff between versions, and rollback; plus
shared.rs SharedStr copy-on-write strings (Python strings are already
immutable+interned, so only the version machinery carries over).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class VersionEntry:
    version: int
    value: Any
    ts: float
    note: str = ""


class VersionedValue:
    """Append-only version chain for one logical record."""

    def __init__(self, initial: Any, note: str = "initial"):
        self._entries: List[VersionEntry] = [
            VersionEntry(1, initial, time.time(), note)
        ]

    @property
    def current(self) -> Any:
        return self._entries[-1].value

    @property
    def version(self) -> int:
        return self._entries[-1].version

    def update(self, value: Any, note: str = "") -> int:
        v = self.version + 1
        self._entries.append(VersionEntry(v, value, time.time(), note))
        return v

    def at(self, version: int) -> Any:
        for e in self._entries:
            if e.version == version:
                return e.value
        raise KeyError(f"version {version} not found")

    def rollback(self, version: int, note: str = "rollback") -> int:
        """Roll back by appending the old value as a new version (history
        is never destroyed, versioning.rs semantics)."""
        return self.update(self.at(version), note=f"{note} to v{version}")

    def history(self) -> List[Tuple[int, str, float]]:
        return [(e.version, e.note, e.ts) for e in self._entries]


class VersionStore:
    """Keyed versioned records (node metadata, config revisions)."""

    def __init__(self) -> None:
        self._data: Dict[str, VersionedValue] = {}

    def put(self, key: str, value: Any, note: str = "") -> int:
        if key in self._data:
            return self._data[key].update(value, note)
        self._data[key] = VersionedValue(value, note or "initial")
        return 1

    def get(self, key: str, version: Optional[int] = None) -> Any:
        vv = self._data[key]
        return vv.current if version is None else vv.at(version)

    def version_of(self, key: str) -> int:
        return self._data[key].version

    def diff(self, key: str, v_old: int, v_new: int) -> Dict[str, Any]:
        """Shallow dict diff between two versions."""
        old, new = self.get(key, v_old), self.get(key, v_new)
        if isinstance(old, dict) and isinstance(new, dict):
            return {
                "added": {k: new[k] for k in new.keys() - old.keys()},
                "removed": {k: old[k] for k in old.keys() - new.keys()},
                "changed": {
                    k: (old[k], new[k])
                    for k in old.keys() & new.keys() if old[k] != new[k]
                },
            }
        return {"changed": {"value": (old, new)}} if old != new else {}

    def rollback(self, key: str, version: int) -> int:
        return self._data[key].rollback(version)

    def __contains__(self, key: str) -> bool:
        return key in self._data


__all__ = ["VersionedValue", "VersionStore", "VersionEntry"]

"""Copy of `codegraph_tpu/utils/debug_logger.py` for the PyTorch port.

Agent debug trace logger.

Reference: codegraph-mcp-core/src/debug_logger.rs:15-166 — when enabled
(env CODEGRAPH_DEBUG_LOG), writes timestamped JSON records of every
agent tool call / reasoning step to a file for offline inspection
(viewer: the reference ships tools/view_debug_logs.py).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional


class DebugLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path or os.environ.get("CODEGRAPH_DEBUG_LOG", "")
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    def log(self, kind: str, **payload: Any) -> None:
        if not self.enabled:
            return
        rec = {"ts": time.time(), "kind": kind, **payload}
        with self._lock:
            try:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec, default=str) + "\n")
            except OSError:
                pass

    def tool_call(self, tool: str, params: Dict, result_preview: str) -> None:
        self.log("tool_call", tool=tool, params=params,
                 result=result_preview[:500])

    def reasoning(self, agent: str, text: str) -> None:
        self.log("reasoning", agent=agent, text=text[:2000])


__all__ = ["DebugLogger"]

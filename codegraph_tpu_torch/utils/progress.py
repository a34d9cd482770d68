"""Copy of `codegraph_tpu/utils/progress.py` for the PyTorch port.

Live per-stage progress lines for long index builds.

Reference: the indexer's indicatif progress bars
(crates/codegraph-mcp/src/indexer.rs:4107 create_batch_progress_bar,
rate + ETA lines; tracing-indicatif wiring). Re-design: a dependency-free
carriage-return line on stderr — `[embed] 12,288/1,048,576 chunks
(8,192/s, ETA 2m06s)` — enabled when stderr is a TTY or
CODEGRAPH_PROGRESS=1, silent otherwise (tests, pipes).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional, TextIO


def _fmt_eta(seconds: float) -> str:
    seconds = max(0, int(seconds))
    if seconds < 60:
        return f"{seconds}s"
    m, s = divmod(seconds, 60)
    if m < 60:
        return f"{m}m{s:02d}s"
    h, m = divmod(m, 60)
    return f"{h}h{m:02d}m"


def progress_enabled(out: TextIO) -> bool:
    env = os.environ.get("CODEGRAPH_PROGRESS", "").strip().lower()
    if env in ("0", "false", "no", "off"):
        return False
    if env in ("1", "true", "yes", "on"):
        return True
    try:
        return out.isatty()
    except Exception:
        return False


class StageProgress:
    """One stage's live line; update() redraws at most every 0.2 s."""

    def __init__(self, name: str, total: Optional[int], unit: str,
                 out: TextIO, enabled: bool):
        self.name = name
        self.total = total
        self.unit = unit
        self.out = out
        self.enabled = enabled
        self.t0 = time.perf_counter()
        self._last_draw = 0.0
        self._last_len = 0
        self.n = 0

    def update(self, n_done: int) -> None:
        self.n = n_done
        if not self.enabled:
            return
        now = time.perf_counter()
        if now - self._last_draw < 0.2 and (
            self.total is None or n_done < self.total
        ):
            return
        self._last_draw = now
        dt = max(now - self.t0, 1e-9)
        rate = n_done / dt
        line = f"[{self.name}] {n_done:,}"
        if self.total:
            line += f"/{self.total:,}"
        line += f" {self.unit} ({rate:,.0f}/s"
        if self.total and rate > 0 and n_done < self.total:
            line += f", ETA {_fmt_eta((self.total - n_done) / rate)}"
        line += ")"
        pad = " " * max(0, self._last_len - len(line))
        self.out.write("\r" + line + pad)
        self.out.flush()
        self._last_len = len(line)

    def done(self, extra: str = "") -> None:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        rate = self.n / dt
        if self.enabled:
            line = (f"[{self.name}] {self.n:,} {self.unit} in "
                    f"{dt:.1f}s ({rate:,.0f}/s)")
            if extra:
                line += f" {extra}"
            pad = " " * max(0, self._last_len - len(line))
            self.out.write("\r" + line + pad + "\n")
            self.out.flush()


class ProgressReporter:
    """Factory for stage lines; disabled instances are zero-cost."""

    def __init__(self, enabled: Optional[bool] = None,
                 out: Optional[TextIO] = None):
        self.out = out if out is not None else sys.stderr
        self.enabled = (
            progress_enabled(self.out) if enabled is None else bool(enabled)
        )

    def stage(self, name: str, total: Optional[int] = None,
              unit: str = "items") -> StageProgress:
        return StageProgress(name, total, unit, self.out, self.enabled)


__all__ = ["ProgressReporter", "StageProgress", "progress_enabled"]

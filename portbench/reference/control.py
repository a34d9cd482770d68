"""The control: the reference put in the tier's place, one precision lower.

`ControlIndex` serves the tier's `reserve`/`add`/`search` with every
precision the configuration states taken one step down (`LOWER`): the
int8 tier's scan in int4 and its bf16 rescore in int8; the bf16 flat
tier in int8. It is what a later change that lowered the precision would
serve, and the comparison has to find it wrong: the benchmark's runs never
use it; `readings.py --control 1` and the tests do. Plain PyTorch only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from portbench.reference.scoring import LOWER, Scorer, merge_top, normalize

#: rows scored at once
CHUNK_ROWS = 1 << 19


class ControlIndex:
    def __init__(self, config: dict, device):
        scoring = config["scoring"]
        self.device = torch.device(device)
        self.dim = int(config["dim"])
        self.scan = LOWER[scoring["scan"]]
        self.rescore = LOWER[scoring["rescore"]] if scoring.get("rescore") else None
        self.candidates = int(scoring.get("candidates", 0))
        self.n_rows = 0
        self._scan_rows = None
        self._rescore_rows = None

    def _held(self, x: torch.Tensor):
        scan = Scorer(self.scan, x[:1]).rows(x)
        rescore = Scorer(self.rescore, x[:1], round_queries=False).rows(x) if self.rescore else None
        return scan, rescore

    def reserve(self, n_rows: int) -> None:
        """Hold n_rows rows in every precision kept (one allocation each)."""
        probe = torch.zeros((1, self.dim), device=self.device)
        scan, rescore = self._held(probe)
        self._scan_rows = _empty_like(scan, n_rows)
        self._rescore_rows = _empty_like(rescore, n_rows) if rescore is not None else None

    def add(self, vectors) -> np.ndarray:
        x = normalize(torch.as_tensor(vectors).to(self.device))
        first, self.n_rows = self.n_rows, self.n_rows + x.shape[0]
        scan, rescore = self._held(x)
        _write(self._scan_rows, first, scan)
        if rescore is not None:
            _write(self._rescore_rows, first, rescore)
        return np.arange(first, self.n_rows)

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        q = normalize(torch.as_tensor(np.asarray(queries, np.float32)).to(self.device))
        cand = max(k, self.candidates)
        scorer = Scorer(self.scan, q)
        vals = torch.full((q.shape[0], cand), -np.inf, device=self.device)
        ids = torch.full((q.shape[0], cand), -1, dtype=torch.int64, device=self.device)
        for base in range(0, self.n_rows, CHUNK_ROWS):
            held = _slice(self._scan_rows, base, min(base + CHUNK_ROWS, self.n_rows))
            vals, ids = merge_top(vals, ids, scorer.block(held), base, cand)
        if self.rescore is not None:
            rescorer = Scorer(self.rescore, q, round_queries=False)
            qi = torch.arange(q.shape[0], device=self.device).repeat_interleave(cand)
            exact = rescorer.pairs(self._rescore_rows, qi, ids.reshape(-1)).float()
            vals, order = torch.sort(exact.reshape(q.shape[0], cand), dim=1, descending=True)
            ids = torch.gather(ids, 1, order)
        return vals[:, :k].cpu().numpy(), ids[:, :k].int().cpu().numpy()


def _empty_like(held, n: int):
    if isinstance(held, tuple):
        return tuple(torch.empty((n,) + h.shape[1:], dtype=h.dtype, device=h.device) for h in held)
    return torch.empty((n,) + held.shape[1:], dtype=held.dtype, device=held.device)


def _write(dst, first: int, src) -> None:
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            d[first: first + s.shape[0]] = s
    else:
        dst[first: first + src.shape[0]] = src


def _slice(held, lo: int, hi: int):
    if isinstance(held, tuple):
        return tuple(h[lo:hi] for h in held)
    return held[lo:hi]

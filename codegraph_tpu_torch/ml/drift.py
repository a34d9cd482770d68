"""Copy of `codegraph_tpu/ml/drift.py` for the PyTorch port.

Embedding/feature drift detection: KL, PSI, KS + retrain triggers.

Reference: crates/codegraph-vector/src/ml/pipeline.rs:22-768 —
MLPipelineConfig drift detection (KL divergence / PSI / KS test,
:98-108) and retrain trigger thresholds. Statistics run as vectorized
numpy over embedding-norm and per-dimension histograms; on-device would
be overkill for monitoring volumes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class DriftReport:
    kl_divergence: float
    psi: float
    ks_statistic: float
    drifted: bool
    detail: Dict[str, float] = field(default_factory=dict)


@dataclass
class DriftThresholds:
    kl: float = 0.5
    psi: float = 0.2    # industry-standard PSI alert level
    ks: float = 0.15


class DriftDetector:
    """Compare a live embedding batch against a reference sample."""

    def __init__(
        self,
        reference: np.ndarray,
        n_bins: int = 32,
        thresholds: Optional[DriftThresholds] = None,
    ):
        self.thresholds = thresholds or DriftThresholds()
        self.n_bins = n_bins
        ref = np.asarray(reference, np.float32)
        # project to scalar summaries: norms + first-PC projection
        self._mean = ref.mean(axis=0)
        centered = ref - self._mean
        # power iteration for the top principal direction
        v = np.random.default_rng(0).standard_normal(ref.shape[1]).astype(np.float32)
        for _ in range(10):
            v = centered.T @ (centered @ v)
            v /= np.linalg.norm(v) + 1e-12
        self._pc = v
        self._ref_proj = centered @ v
        self._edges = np.quantile(
            self._ref_proj, np.linspace(0, 1, n_bins + 1)
        )
        self._edges[0], self._edges[-1] = -np.inf, np.inf
        self._ref_hist = self._hist(self._ref_proj)

    def _hist(self, proj: np.ndarray) -> np.ndarray:
        counts, _ = np.histogram(proj, bins=self._edges)
        p = counts.astype(np.float64) + 0.5  # Laplace smoothing
        return p / p.sum()

    def check(self, batch: np.ndarray) -> DriftReport:
        x = np.asarray(batch, np.float32)
        proj = (x - self._mean) @ self._pc
        p, q = self._ref_hist, self._hist(proj)
        kl = float(np.sum(q * np.log(q / p)))
        psi = float(np.sum((q - p) * np.log(q / p)))
        # KS over the projection
        ref_sorted = np.sort(self._ref_proj)
        ks = _ks_stat(ref_sorted, np.sort(proj))
        t = self.thresholds
        drifted = kl > t.kl or psi > t.psi or ks > t.ks
        return DriftReport(
            kl_divergence=kl, psi=psi, ks_statistic=ks, drifted=drifted,
            detail={"n_ref": len(self._ref_proj), "n_batch": len(proj)},
        )


def _ks_stat(a: np.ndarray, b: np.ndarray) -> float:
    grid = np.concatenate([a, b])
    grid.sort()
    cdf_a = np.searchsorted(a, grid, side="right") / len(a)
    cdf_b = np.searchsorted(b, grid, side="right") / len(b)
    return float(np.abs(cdf_a - cdf_b).max())


__all__ = ["DriftDetector", "DriftReport", "DriftThresholds"]

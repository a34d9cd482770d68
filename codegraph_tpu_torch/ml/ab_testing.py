"""Copy of `codegraph_tpu/ml/ab_testing.py` for the PyTorch port.

A/B testing framework for retrieval/model variants.

Reference: crates/codegraph-vector/src/ml/ab_testing.rs:363-1052 —
experiments with traffic allocation, metric collection, statistical
tests (Welch t-test / Mann-Whitney / bootstrap, :88-101), early
stopping. Assignment is deterministic per subject id (hash-based) so a
user/query sticks to its arm.
"""

from __future__ import annotations

import hashlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class ArmStats:
    values: List[float] = field(default_factory=list)

    def record(self, v: float) -> None:
        self.values.append(v)

    @property
    def n(self) -> int:
        return len(self.values)

    @property
    def mean(self) -> float:
        return float(np.mean(self.values)) if self.values else 0.0

    @property
    def var(self) -> float:
        return float(np.var(self.values, ddof=1)) if len(self.values) > 1 else 0.0


@dataclass
class ABExperiment:
    name: str
    arms: List[str]
    traffic: List[float]  # allocation fractions, sums to 1
    metric: str = "latency_ms"
    min_samples: int = 30
    significance: float = 0.05
    created_at: float = field(default_factory=time.time)
    stats: Dict[str, ArmStats] = field(default_factory=dict)
    stopped: bool = False
    winner: Optional[str] = None

    def __post_init__(self):
        if abs(sum(self.traffic) - 1.0) > 1e-6:
            raise ValueError("traffic fractions must sum to 1")
        for arm in self.arms:
            self.stats.setdefault(arm, ArmStats())

    def assign(self, subject_id: str) -> str:
        """Deterministic hash-based arm assignment."""
        h = hashlib.blake2b(
            f"{self.name}|{subject_id}".encode(), digest_size=8
        ).digest()
        u = int.from_bytes(h, "little") / 2**64
        acc = 0.0
        for arm, frac in zip(self.arms, self.traffic):
            acc += frac
            if u < acc:
                return arm
        return self.arms[-1]

    def record(self, arm: str, value: float) -> None:
        self.stats[arm].record(value)

    # -- statistical tests (ab_testing.rs:88-101) -------------------------

    def welch_t(self, a: str, b: str) -> Tuple[float, float]:
        """Welch's t statistic + 2-sided p approximation (normal tail)."""
        sa, sb = self.stats[a], self.stats[b]
        if sa.n < 2 or sb.n < 2:
            return 0.0, 1.0
        se = math.sqrt(sa.var / sa.n + sb.var / sb.n)
        if se == 0:
            return 0.0, 1.0
        t = (sa.mean - sb.mean) / se
        p = 2.0 * (1.0 - _phi(abs(t)))
        return t, p

    def mann_whitney(self, a: str, b: str) -> Tuple[float, float]:
        """Mann-Whitney U with normal approximation."""
        xa, xb = self.stats[a].values, self.stats[b].values
        na, nb = len(xa), len(xb)
        if na < 2 or nb < 2:
            return 0.0, 1.0
        combined = np.concatenate([xa, xb])
        # midranks for ties (argsort-of-argsort assigns arbitrary
        # distinct ranks to equal values, biasing U on rounded metrics)
        order = np.argsort(combined, kind="mergesort")
        ranks = np.empty(len(combined))
        sorted_v = combined[order]
        i = 0
        tie_term = 0.0
        while i < len(sorted_v):
            j = i
            while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
                j += 1
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
            t = j - i + 1
            tie_term += t**3 - t
            i = j + 1
        ra = float(ranks[:na].sum())
        u = ra - na * (na + 1) / 2
        mu = na * nb / 2
        n = na + nb
        # normal approximation with tie correction
        sigma = math.sqrt(
            na * nb / 12.0 * ((n + 1) - tie_term / (n * (n - 1)))
        )
        if sigma == 0:
            return u, 1.0
        z = (u - mu) / sigma
        return u, 2.0 * (1.0 - _phi(abs(z)))

    def bootstrap_diff(
        self, a: str, b: str, n_boot: int = 1000, seed: int = 0
    ) -> Tuple[float, Tuple[float, float]]:
        """Bootstrap CI of mean difference."""
        xa = np.asarray(self.stats[a].values)
        xb = np.asarray(self.stats[b].values)
        rng = np.random.default_rng(seed)
        diffs = [
            rng.choice(xa, len(xa)).mean() - rng.choice(xb, len(xb)).mean()
            for _ in range(n_boot)
        ]
        lo, hi = np.percentile(diffs, [2.5, 97.5])
        return float(xa.mean() - xb.mean()), (float(lo), float(hi))

    def check_early_stop(self, lower_is_better: bool = True) -> Optional[str]:
        """Declare a winner when significant with enough samples."""
        if self.stopped or len(self.arms) != 2:
            return self.winner
        a, b = self.arms
        if self.stats[a].n < self.min_samples or self.stats[b].n < self.min_samples:
            return None
        _, p = self.welch_t(a, b)
        if p < self.significance:
            better = (
                a if (self.stats[a].mean < self.stats[b].mean) == lower_is_better
                else b
            )
            self.stopped = True
            self.winner = better
        return self.winner

    def report(self) -> Dict:
        out = {
            "name": self.name, "metric": self.metric,
            "stopped": self.stopped, "winner": self.winner, "arms": {},
        }
        for arm in self.arms:
            s = self.stats[arm]
            out["arms"][arm] = {"n": s.n, "mean": round(s.mean, 4),
                                "var": round(s.var, 4)}
        if len(self.arms) == 2:
            t, p = self.welch_t(*self.arms)
            out["welch_t"] = round(t, 4)
            out["p_value"] = round(p, 5)
        return out


def _phi(x: float) -> float:
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


class ABTestingFramework:
    def __init__(self) -> None:
        self.experiments: Dict[str, ABExperiment] = {}

    def create(self, name: str, arms: List[str],
               traffic: Optional[List[float]] = None, **kw) -> ABExperiment:
        traffic = traffic or [1.0 / len(arms)] * len(arms)
        exp = ABExperiment(name=name, arms=arms, traffic=traffic, **kw)
        self.experiments[name] = exp
        return exp

    def assign(self, name: str, subject_id: str) -> str:
        return self.experiments[name].assign(subject_id)

    def record(self, name: str, arm: str, value: float) -> None:
        self.experiments[name].record(arm, value)

    def report(self) -> Dict[str, Dict]:
        return {n: e.report() for n, e in self.experiments.items()}


__all__ = ["ABExperiment", "ABTestingFramework", "ArmStats"]

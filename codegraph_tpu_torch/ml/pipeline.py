"""Copy of `codegraph_tpu/ml/pipeline.py` for the PyTorch port: `MLLifecycle` saves,
loads and registers encoders through the port's `save_encoder_checkpoint`
and `EncoderProvider`, on the device it is given ("cuda" unless the
caller asks for "cpu").

ML lifecycle pipeline: drift monitoring -> retrain triggers.

Reference: crates/codegraph-vector/src/ml/pipeline.rs:22-768 —
MLPipelineConfig wiring the drift detectors (KL/PSI/KS, :98-108) to
retrain actions with trigger policies. Round 1 shipped detection only
(ml/drift.py); this closes the loop: observed embedding batches feed
the detector, a policy decides when drift warrants retraining
(consecutive drifted batches + cooldown + minimum accumulated samples),
and the retrain callback runs with the accumulated drifted sample pool.
The reference executes its retrain as a training job; here the callback
seam lets deployments plug the contrastive trainer
(models/training.py) or any external process.
"""

from __future__ import annotations

import enum
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from codegraph_tpu_torch.ml.drift import DriftDetector, DriftReport, DriftThresholds

logger = logging.getLogger("codegraph_tpu_torch.ml")


@dataclass
class RetrainPolicy:
    """When does drift trigger a retrain (pipeline.rs trigger config)."""

    consecutive_drifted: int = 3      # drifted batches in a row
    cooldown_s: float = 3600.0        # min seconds between retrains
    min_samples: int = 512            # accumulated drifted rows needed
    max_pool: int = 50_000            # retain at most this many rows


@dataclass
class RetrainEvent:
    at: float
    reports: List[DriftReport]
    n_samples: int
    succeeded: bool
    detail: str = ""


class MLPipeline:
    """observe(batch) -> DriftReport, firing retrain_fn per policy.

    retrain_fn(samples [N, D]) -> bool; on success the detector's
    reference distribution is refreshed from the pool (the new "normal"),
    matching the reference pipeline's post-retrain baseline reset.
    """

    def __init__(
        self,
        reference: np.ndarray,
        retrain_fn: Optional[Callable[[np.ndarray], bool]] = None,
        policy: Optional[RetrainPolicy] = None,
        thresholds: Optional[DriftThresholds] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._reference = np.asarray(reference, np.float32)
        self._thresholds = thresholds
        self.detector = DriftDetector(self._reference, thresholds=thresholds)
        self.retrain_fn = retrain_fn
        self.policy = policy or RetrainPolicy()
        self._clock = clock
        self._streak: List[DriftReport] = []
        self._pool: List[np.ndarray] = []
        self._pool_rows = 0
        self._last_retrain = -float("inf")
        self.events: List[RetrainEvent] = []

    # -- observation -------------------------------------------------------

    def observe(self, batch: np.ndarray) -> DriftReport:
        report = self.detector.check(batch)
        if report.drifted:
            self._streak.append(report)
            self._pool.append(np.asarray(batch, np.float32))
            self._pool_rows += len(batch)
            while self._pool_rows > self.policy.max_pool and len(self._pool) > 1:
                self._pool_rows -= len(self._pool.pop(0))
        else:
            self._streak = []
        if self._should_retrain():
            self._retrain()
        return report

    def _should_retrain(self) -> bool:
        p = self.policy
        return (
            len(self._streak) >= p.consecutive_drifted
            and self._pool_rows >= p.min_samples
            and (self._clock() - self._last_retrain) >= p.cooldown_s
        )

    # -- retrain -----------------------------------------------------------

    def _retrain(self) -> None:
        samples = np.concatenate(self._pool, axis=0)
        reports = list(self._streak)
        ok = False
        detail = ""
        if self.retrain_fn is not None:
            try:
                ok = bool(self.retrain_fn(samples))
            except Exception as exc:
                detail = f"{type(exc).__name__}: {exc}"
                logger.warning("retrain failed: %s", exc)
        else:
            detail = "no retrain_fn configured"
        self.events.append(RetrainEvent(
            at=self._clock(), reports=reports, n_samples=len(samples),
            succeeded=ok, detail=detail,
        ))
        self._last_retrain = self._clock()
        self._streak = []
        if ok:
            # the drifted distribution becomes the new baseline
            self._reference = samples[-min(len(samples), 10_000):]
            self.detector = DriftDetector(
                self._reference, thresholds=self._thresholds)
            self._pool = []
            self._pool_rows = 0

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, object]:
        return {
            "streak": len(self._streak),
            "pool_rows": self._pool_rows,
            "retrains": len(self.events),
            "last_succeeded": self.events[-1].succeeded if self.events else None,
        }


class PipelineStatus(enum.Enum):
    """pipeline.rs:167-184 lifecycle states."""

    READY = "ready"
    TRAINING = "training"
    PAUSED = "paused"
    ERROR = "error"


class MLLifecycle:
    """Unifying ML facade (reference: MLPipeline, pipeline.rs:202-660 —
    one object wiring feature extraction, training, inference, model
    registry save/load, A/B experiments, drift detection and retrain
    triggers, with pause/resume and status/monitoring).

    The rebuild keeps each capability in its own module (ml/features,
    ml/ab_testing, ml/drift + MLPipeline above, models/providers for
    inference/checkpoints); this facade composes them behind the
    reference's surface: register/save/load named models (encoder
    checkpoints via save/load_encoder_checkpoint), predict/
    predict_batch, start_ab_test/predict_with_ab_test/analyze_ab_test,
    extract_features(_batch), observe() drift -> retrain, pause/resume,
    get_status/monitor_performance. `device`: where loaded encoders run
    ("cuda" unless the caller asks for "cpu").
    """

    def __init__(
        self,
        drift_reference: Optional[np.ndarray] = None,
        retrain_fn: Optional[Callable[[np.ndarray], bool]] = None,
        policy: Optional[RetrainPolicy] = None,
        thresholds: Optional[DriftThresholds] = None,
        device="cuda",
    ):
        from codegraph_tpu_torch.ml.ab_testing import ABTestingFramework

        self.device = device
        self.models: Dict[str, object] = {}  # name -> EmbeddingProvider-like
        self.ab = ABTestingFramework()
        self.drift_loop = (
            MLPipeline(drift_reference, retrain_fn=self._on_retrain,
                       policy=policy, thresholds=thresholds)
            if drift_reference is not None else None
        )
        self._user_retrain_fn = retrain_fn
        self._status = PipelineStatus.READY
        self._error: str = ""

    # -- model registry (pipeline.rs:488-512 save/load_model) --------------

    def register_model(self, name: str, provider) -> None:
        """provider: anything with embed_texts(texts) -> [n, d]."""
        self.models[name] = provider

    def save_model(self, name: str, path: str) -> None:
        from codegraph_tpu_torch.models.providers import save_encoder_checkpoint

        provider = self._model(name)
        enc = getattr(provider, "encoder", provider)
        params = getattr(enc, "params", None)
        if params is None:
            raise ValueError(f"model {name!r} has no savable params")
        save_encoder_checkpoint(path, params, cfg=getattr(enc, "cfg", None))

    def load_model(self, name: str, path: str, **encoder_kwargs) -> None:
        from codegraph_tpu_torch.models.providers import EncoderProvider

        encoder_kwargs.setdefault("device", self.device)
        self.models[name] = EncoderProvider(checkpoint=path,
                                            **encoder_kwargs)

    def _model(self, name: str):
        if name not in self.models:
            raise KeyError(f"unknown model {name!r}; registered: "
                           f"{sorted(self.models)}")
        return self.models[name]

    # -- inference (pipeline.rs:380-394 predict/predict_batch) -------------

    def predict(self, model_name: str, text: str) -> np.ndarray:
        return self.predict_batch(model_name, [text])[0]

    def predict_batch(self, model_name: str,
                      texts: List[str]) -> np.ndarray:
        if self._status == PipelineStatus.PAUSED:
            raise RuntimeError("pipeline is paused")
        return self._model(model_name).embed_texts(list(texts))

    # -- A/B experiments (pipeline.rs:396-425) ------------------------------

    def start_ab_test(self, name: str, arms: List[str], **kw) -> str:
        """Arms are registered model names; traffic splits per subject."""
        for arm in arms:
            self._model(arm)  # validate upfront
        self.ab.create(name, arms, **kw)
        return name

    def predict_with_ab_test(self, experiment: str, subject_id: str,
                             texts: List[str]):
        """Returns (arm, embeddings); record outcomes via record_ab()."""
        arm = self.ab.assign(experiment, subject_id)
        return arm, self.predict_batch(arm, texts)

    def record_ab(self, experiment: str, arm: str, value: float) -> None:
        self.ab.record(experiment, arm, value)

    def analyze_ab_test(self, experiment: str) -> Dict:
        return self.ab.experiments[experiment].report()

    # -- features (pipeline.rs:427-440) --------------------------------------

    @staticmethod
    def extract_features(node) -> Dict[str, float]:
        from codegraph_tpu_torch.ml.features import extract_code_features

        return extract_code_features(node)

    def extract_features_batch(self, nodes) -> List[Dict[str, float]]:
        return [self.extract_features(n) for n in nodes]

    # -- training (pipeline.rs:335-378 train_model) --------------------------

    def train_model(self, name: str,
                    train_fn: Callable[[], object]) -> object:
        """Run a training job (e.g. models/training.py contrastive
        fine-tune) under lifecycle state tracking; the result (a provider
        or checkpoint path) is registered under `name`."""
        if self._status == PipelineStatus.PAUSED:
            raise RuntimeError("pipeline is paused")
        self._status = PipelineStatus.TRAINING
        try:
            result = train_fn()
        except Exception as exc:
            self._status = PipelineStatus.ERROR
            self._error = f"{type(exc).__name__}: {exc}"
            raise
        self._status = PipelineStatus.READY
        if isinstance(result, str):
            self.load_model(name, result)
        elif result is not None:
            self.models[name] = result
        return result

    # -- drift (pipeline.rs:543-651 detect_data_drift/should_retrain) -------

    def observe(self, batch: np.ndarray) -> Optional[DriftReport]:
        if self.drift_loop is None or self._status == PipelineStatus.PAUSED:
            return None
        return self.drift_loop.observe(batch)

    def _on_retrain(self, samples: np.ndarray) -> bool:
        if self._user_retrain_fn is None:
            return False
        self._status = PipelineStatus.TRAINING
        try:
            return bool(self._user_retrain_fn(samples))
        except Exception:
            self._status = PipelineStatus.ERROR
            raise
        finally:
            if self._status == PipelineStatus.TRAINING:
                self._status = PipelineStatus.READY

    # -- lifecycle (pipeline.rs:442-458, 653-667) ----------------------------

    def pause(self) -> None:
        self._status = PipelineStatus.PAUSED

    def resume(self) -> None:
        if self._status == PipelineStatus.PAUSED:
            self._status = PipelineStatus.READY

    def get_status(self) -> PipelineStatus:
        return self._status

    def monitor_performance(self) -> Dict[str, Dict[str, float]]:
        """Per-model throughput/failure counters (pipeline.rs:514-541),
        pulled from each provider's EmbeddingMetrics when present."""
        out: Dict[str, Dict[str, float]] = {}
        for name, provider in self.models.items():
            m = getattr(provider, "metrics", None)
            if m is None:
                continue
            out[name] = {
                "texts": float(m.texts),
                "failures": float(m.failures),
                "texts_per_second": float(m.texts_per_second),
            }
        if self.drift_loop is not None:
            out["drift"] = {
                k: float(v) for k, v in self.drift_loop.stats().items()
                if isinstance(v, (int, float))
            }
        return out

    def get_context(self) -> Dict[str, object]:
        return {
            "status": self._status.value,
            "error": self._error,
            "models": sorted(self.models),
            "experiments": sorted(self.ab.experiments),
            "drift": self.drift_loop.stats() if self.drift_loop else None,
        }


__all__ = ["MLPipeline", "MLLifecycle", "PipelineStatus", "RetrainPolicy",
           "RetrainEvent"]

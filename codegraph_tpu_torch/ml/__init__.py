"""Copy of `codegraph_tpu/ml/__init__.py` for the PyTorch port.

ML lifecycle: A/B testing, drift detection, code features.

Re-implements the reference's ML module family
(crates/codegraph-vector/src/ml/: ab_testing.rs:363-1052 experiments +
stat tests, pipeline.rs:22-768 drift detection (KL/PSI/KS) + retrain
triggers, features.rs:14-503 hand-crafted code features). The inference
engine (ml/inference.rs) is folded into the on-chip encoder
(models/encoder.py); training lives in models/training.py.
"""

from codegraph_tpu_torch.ml.ab_testing import ABExperiment, ABTestingFramework
from codegraph_tpu_torch.ml.drift import DriftDetector, DriftReport
from codegraph_tpu_torch.ml.features import extract_code_features

__all__ = [
    "ABExperiment",
    "ABTestingFramework",
    "DriftDetector",
    "DriftReport",
    "extract_code_features",
]

"""The port's planner (`codegraph_tpu_torch.utils.tuning`) and the
auto-tuned `CodeGraph.open` held to the JAX package on the CPU.

The plans must be equal field for field (the reason strings are the
port's own and only checked to be present); a CodeGraph opened with a
capacity that the planner sends to the int8 tier must build the same
index tier in both packages and return the same hybrid results (scores
within 1e-5: rescored f32 dot products summed in another order).
"""

import dataclasses

import numpy as np
import pytest

from codegraph_tpu.api import CodeGraph as JCodeGraph
from codegraph_tpu.core.config import CodeGraphConfig as JConfig
from codegraph_tpu.index.int8_flat import Int8FlatIndex as JInt8
from codegraph_tpu.utils import tuning as jtuning
from codegraph_tpu_torch.api import CodeGraph as TCodeGraph
from codegraph_tpu_torch.api import index_memory_budget
from codegraph_tpu_torch.core.config import CodeGraphConfig as TConfig
from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex as TInt8
from codegraph_tpu_torch.utils import tuning as ttuning

TOL = 1e-5
SIZES = [1, 50_000, 199_999, 200_000, 1_000_000, 2_000_000, 4_000_000, 5_600_000,
         6_000_000, 10_000_000, 11_200_000, 30_000_000, 100_000_000]


def _fields(plan):
    d = dataclasses.asdict(plan)
    assert d.pop("reason")
    return d


@pytest.mark.parametrize("budget", [2 << 30, 8 << 30, 16 << 30, 40 << 30])
@pytest.mark.parametrize("batch_hint", [1, 256, 1024, 4096])
def test_plan_index_matches_jax(budget, batch_hint):
    kinds = set()
    for n in SIZES:
        for dim in (128, 384, 768, 1536):
            for recall in (0.9, 0.95, 0.99):
                kw = dict(hbm_budget_bytes=budget, target_recall=recall, batch_hint=batch_hint)
                want = jtuning.plan_index(n, dim, **kw)
                got = ttuning.plan_index(n, dim, **kw)
                assert _fields(got) == _fields(want), (n, dim, kw)
                kinds.add((got.kind, got.dtype))
    assert {("flat", "float32"), ("flat", "int8"), ("ivfpq", "int8")} <= kinds


def test_default_budget_and_apply_plan_match_jax():
    assert ttuning.DEFAULT_HBM_BUDGET == jtuning.DEFAULT_HBM_BUDGET
    assert index_memory_budget("cpu") == jtuning.DEFAULT_HBM_BUDGET
    for n, hint in ((50_000, 256), (1_000_000, 256), (4_000_000, 2048), (10_000_000, 256),
                    (100_000_000, 256)):
        jc, tc = JConfig(), TConfig()
        jtuning.apply_plan(jc, jtuning.plan_index(n, 768, batch_hint=hint))
        ttuning.apply_plan(tc, ttuning.plan_index(n, 768, batch_hint=hint))
        assert dataclasses.asdict(tc.index) == dataclasses.asdict(jc.index), n


def _project(tmp_path):
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "a.py").write_text(
        "def alpha(x):\n    \"\"\"Scale a value.\"\"\"\n    return beta(x) + 1\n\n"
        "def beta(y):\n    return y * 2\n\n"
        "class Loader:\n    def load(self, path):\n        return open(path).read()\n")
    (proj / "b.py").write_text(
        "from a import alpha, Loader\n\nclass Gamma:\n    def run(self):\n"
        "        return alpha(3)\n\n    def read(self, p):\n        return Loader().load(p)\n")
    return proj


def _cfg(cls, data_dir, capacity):
    cfg = cls()
    cfg.embedding.provider = "hash"
    cfg.embedding.dimension = 768
    cfg.index.capacity = capacity
    cfg.data_dir = str(data_dir)
    return cfg


def test_open_with_capacity_planned_to_int8_matches_jax(tmp_path):
    """6M x 768 rows: bf16 (9.2 GB) is over the 8 GiB CPU budget, int8
    (4.6 GB) fits, so both packages build the int8 tier."""
    proj = _project(tmp_path)
    j = JCodeGraph.open(str(proj), config=_cfg(JConfig, tmp_path / "j", 6_000_000))
    t = TCodeGraph.open(str(proj), config=_cfg(TConfig, tmp_path / "t", 6_000_000),
                        device="cpu")
    assert (t.config.index.kind, t.config.index.dtype, t.config.index.rescore_k) == \
        (j.config.index.kind, j.config.index.dtype, j.config.index.rescore_k) == ("flat", "int8", 100)
    assert isinstance(j.indexer.index, JInt8) and isinstance(t.indexer.index, TInt8)
    j.index()
    t.index()
    assert len(t.indexer.index) == len(j.indexer.index) > 0
    for query in ("scale a value", "load a file path", "gamma run"):
        a, b = j.search(query, limit=5), t.search(query, limit=5)
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert abs(x.score - y.score) <= TOL
        assert a[0].node_id == b[0].node_id
    s_t, i_t = t.indexer.index.search(np.ones((2, 768), np.float32), 3)
    assert s_t.shape == (2, 3) and (i_t >= 0).all()

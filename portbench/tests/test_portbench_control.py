"""The comparison fails what it must: the control (the reference one
precision lower, in the tier's place) and the faults a served search can
have, each planted under a whole run at tiny size on the CPU."""

import json

import numpy as np
import pytest

from portbench.harness import ROOT, run_cell
from portbench.reference.control import ControlIndex
from portbench.tests.tiny import TINY, tiny_cell

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SERVICE_CELLS = [c for c in CELLS if c.endswith(".c256")]


class AlteredAnswer:
    """Each batch's first answer has one row replaced where it is produced."""

    def __init__(self, index):
        self.index = index

    def search(self, queries, k):
        scores, ids = self.index.search(queries, k)
        ids = ids.copy()
        ids[0, k // 2] = (ids[0, k // 2] + TINY["n_rows"] // 2) % TINY["n_rows"]
        return scores, ids


class HalfBatch:
    """Only the first half of each batch is searched; the rest is given
    the first half's answers."""

    def __init__(self, index):
        self.index = index

    def search(self, queries, k):
        half = (queries.shape[0] + 1) // 2
        scores, ids = self.index.search(queries[:half], k)
        rows = np.arange(queries.shape[0]) % half
        return scores[rows], ids[rows]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    result = run_cell(tiny_cell(cell, clients=32), seed=2**31 + 7, seconds=0.4, device="cpu",
                      make_index=ControlIndex)
    assert not result["correct"]
    checks = result["checks"]
    assert checks["scan_gap"]["value"] > checks["scan_gap"]["limit"] or \
        checks["score_err"]["value"] > checks["score_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(cell):
    result = run_cell(tiny_cell(cell), seed=2**31 + 8, seconds=0.4, device="cpu",
                      wrap=AlteredAnswer)
    assert not result["correct"]


@pytest.mark.parametrize("cell", SERVICE_CELLS)
def test_half_of_the_batch_left_out_is_not_correct(cell):
    result = run_cell(tiny_cell(cell), seed=2**31 + 9, seconds=0.4, device="cpu", wrap=HalfBatch)
    assert not result["correct"]

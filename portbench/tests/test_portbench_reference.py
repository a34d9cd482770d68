"""The plain reference against the port's CPU path at tiny sizes, and
whole runs of every cell at tiny size on the CPU."""

import json

import numpy as np
import pytest
import torch

from portbench.harness import ROOT, run_cell
from portbench.reference.scoring import Scorer, merge_top, normalize, quantize
from portbench.tests.tiny import tiny_cell

from codegraph_tpu_torch.index.flat import FlatIndex
from codegraph_tpu_torch.index.int8_flat import Int8FlatIndex
from codegraph_tpu_torch.ops.quantize import quantize_rows

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _data(n=2500, d=48, b=7, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g), torch.randn(b, d, generator=g)


def test_quantize_equals_the_ports():
    x = normalize(_data()[0])
    q, s = quantize(x, "int8")
    pq, ps = quantize_rows(x)
    assert torch.equal(q, pq) and torch.equal(s, ps)


def _reference_search(precision, rescore, x, q, k, cand):
    scan = Scorer(precision, normalize(q))
    held = scan.rows(normalize(x))
    v, i = merge_top(torch.full((q.shape[0], cand), -np.inf),
                     torch.full((q.shape[0], cand), -1, dtype=torch.int64), scan.block(held), 0, cand)
    if rescore is None:
        return v[:, :k], i[:, :k]
    res = Scorer(rescore, normalize(q), round_queries=False)
    qi = torch.arange(q.shape[0]).repeat_interleave(cand)
    exact = res.pairs(res.rows(normalize(x)), qi, i.reshape(-1)).float().reshape(q.shape[0], cand)
    order = torch.sort(exact, dim=1, descending=True).indices
    return torch.gather(exact, 1, order)[:, :k], torch.gather(i, 1, order)[:, :k]


@pytest.mark.parametrize("k", [10, 100])
def test_int8_tier_equals_the_reference(k):
    x, q = _data()
    idx = Int8FlatIndex(x.shape[1], "cosine", rescore_dtype="bfloat16", rescore_k=100, device="cpu")
    idx.add(x)
    s, i = idx.search(q.numpy(), k)
    rs, ri = _reference_search("int8", "bfloat16", x, q, k, max(k, 100))
    assert np.array_equal(np.sort(i, 1), np.sort(ri.numpy(), 1))
    np.testing.assert_allclose(s, rs.numpy(), rtol=0, atol=1e-6)


def test_bf16_flat_tier_equals_the_reference():
    x, q = _data()
    idx = FlatIndex(x.shape[1], "cosine", dtype="bfloat16", device="cpu")
    idx.add(x)
    s, i = idx.search(q.numpy(), 100)
    rs, ri = _reference_search("bfloat16", None, x, q, 100, 100)
    assert np.array_equal(np.sort(i, 1), np.sort(ri.numpy(), 1))
    np.testing.assert_allclose(s, rs.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("cell", CELLS)
def test_whole_run_at_tiny_size_is_correct(cell):
    tiny = tiny_cell(cell)
    result = run_cell(tiny, seed=2**31 + 99, seconds=0.4, device="cpu")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    metrics = result["metrics"]
    # every end-to-end metric of the cell but the card's memory
    assert set(metrics) == {m["name"] for m in tiny.end_to_end} - {"device_mem_gib"}
    assert 0.5 < metrics["recall_at_k"]["value"] <= 1.0
    assert list(result)[-1] == "checks"


def test_same_seed_same_inputs():
    from portbench.data import GaussianMixture

    cfg = tiny_cell(CELLS[0]).config
    a = GaussianMixture(cfg["generator"], cfg["dim"], 2**33 + 5, "cpu")
    b = GaussianMixture(cfg["generator"], cfg["dim"], 2**33 + 5, "cpu")
    for (ba, xa), (bb, xb) in zip(a.blocks(cfg["n_rows"]), b.blocks(cfg["n_rows"])):
        assert ba == bb and torch.equal(xa, xb)
    assert torch.equal(a.queries(5), b.queries(5))
    c = GaussianMixture(cfg["generator"], cfg["dim"], 2**33 + 6, "cpu")
    assert not torch.equal(a.queries(5), c.queries(5))

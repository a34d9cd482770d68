"""The entry point: it needs a card and never falls back, it refuses to
run without the program, it holds no JAX, and the reference imports
nothing of the port. One case runs a tiny cell on the card."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.harness import PKG_DIR, ROOT

CELL = "cohere10m-int8.serial"
ARGS = ["--workload", CELL, "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"]


def _run(cwd, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_it_fails_and_prints_no_result():
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "card" in proc.stderr


def test_without_the_program_it_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_are_compared_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "codegraph_tpu_torch_probe", object())
    assert "codegraph_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "codegraph_tpu.probe", object())
    assert "codegraph_tpu" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert "jaxlib" in harness.forbidden_modules()


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"torch", "numpy", "portbench", "__future__", "contextlib", "typing"}
    for path in (PKG_DIR / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] in allowed, (path.name, name)
                if name.startswith("portbench"):
                    assert name.startswith("portbench.reference"), (path.name, name)
    code = ("import sys, portbench.reference.check, portbench.reference.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'codegraph_tpu', 'codegraph_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the tiers' kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_tiny_cell_runs_correct_on_the_card(card):
    from portbench.tests.tiny import tiny_cell

    result = harness.run_cell(tiny_cell(CELL), seed=2**31 + 3, seconds=1.0, device=card)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"

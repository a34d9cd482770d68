"""The port stands alone: it imports nothing of JAX or of the JAX package.

`tests/conftest.py` imports JAX in every test process, so the import check
runs in a fresh subprocess where `jax` and `codegraph_tpu` cannot be
imported at all. The same goes for `chip_smoke.py`, which must also refuse
to run (non-zero exit, no result line) where there is no GPU or no repo.
"""

import ast
import os
import re
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "codegraph_tpu_torch")

BLOCKED_IMPORT = r"""
import ast, importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "codegraph_tpu"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
sys.modules["jax"] = None
import codegraph_tpu_torch
names = [m.name for m in pkgutil.walk_packages(codegraph_tpu_torch.__path__,
                                                "codegraph_tpu_torch.")]
for name in names:
    importlib.import_module(name)
ast.parse(open("chip_smoke.py").read())
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "codegraph_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("imported", len(names))
"""


def _run(args, cwd, timeout=120):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_every_module_imports_without_jax():
    proc = _run(["-c", BLOCKED_IMPORT], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 40


# the modules of the serving surface's last slice: each imports alone
SERVING_MODULES = [
    "models.cross_encoder", "search.reranker", "rag", "rag.retriever", "rag.ranker",
    "rag.generator", "rag.system", "rag.insights", "search.router", "index.segments",
    "indexer.writer", "graph.consistency", "core.versioning", "parser.diff", "parser.semantic",
    "version", "api",
]


# the modules of the training and shared-memory slice
TRAINING_SHM_MODULES = [
    "core.shm", "index.snapshot", "search.service", "models.training", "models.encoder", "ml",
    "ml.drift", "ml.ab_testing", "ml.features", "ml.pipeline",
]


@pytest.mark.parametrize("module", SERVING_MODULES + TRAINING_SHM_MODULES)
def test_serving_module_imports_alone_without_jax(module):
    code = BLOCKED_IMPORT.split("import codegraph_tpu_torch\n")[0] + (
        f"import codegraph_tpu_torch.{module}\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'codegraph_tpu') and sys.modules[m] is not None)\n"
        "assert not leaked, leaked\n")
    proc = _run(["-c", code], cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert os.path.exists(os.path.join(PKG, *module.split("."))) or os.path.exists(
        os.path.join(PKG, *module.split(".")) + ".py")


def test_no_import_line_names_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|codegraph_tpu)([.\s]|$)")
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    hits = [(f, n) for f in files for n, line in enumerate(open(f), 1) if pattern.match(line)]
    assert not hits


def test_chip_smoke_parses_and_imports_no_jax():
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert not mods & {"jax", "jaxlib", "codegraph_tpu"}


def test_chip_smoke_binds_each_top_level_name_once():
    """Phases share one module namespace: a constant or helper bound twice
    silently replaces an earlier phase's."""
    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [x.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets
              for x in ast.walk(t) if isinstance(x, ast.Name)]
    assert sorted(k for k in set(names) if names.count(k) > 1) == []


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py would run for real")
    proc = _run(["chip_smoke.py"], cwd=REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    alone = _run(["chip_smoke.py"], cwd=tmp_path)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout

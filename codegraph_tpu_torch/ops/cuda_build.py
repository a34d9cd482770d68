"""Build and load the port's CUDA kernels (`codegraph_tpu_torch/csrc/*.cu`).

Each source is compiled with plain `nvcc` into a shared library with a C
interface, keyed by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, into
`codegraph_tpu_torch/_build/` (ignored by git), and loaded with ctypes.
Nothing here runs at import time: the first call that launches a kernel
builds it. A failed build raises with nvcc's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills, kept in the .log
)
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "cannot be built")
    return found


def library_path(name: str, nvcc: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join((nvcc,) + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library for this source exists.
    Returns the library's path; nvcc's output is kept beside it (.log)."""
    nvcc = find_nvcc()
    so = library_path(name, nvcc)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S, check=True)
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {exc.returncode}):\n"
            f"{exc.stdout}\n{exc.stderr}") from exc
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and spill lines) for the current source."""
    log = library_path(name, find_nvcc()).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Iterable[str]) -> None:
    """Build several sources at once, one nvcc each, all started together."""
    names = list(names)
    errors = []

    def _one(n):
        try:
            build(n)
        except Exception as exc:  # reported below, after every build ends
            errors.append(exc)

    threads = [threading.Thread(target=_one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


__all__ = ["build", "build_all", "build_log", "find_nvcc", "load"]

"""Build and load the port's native code: the CUDA kernels
(`codegraph_tpu_torch/csrc/*.cu`) and the host library (`csrc/cghost.cpp`).

Each CUDA source is compiled with plain `nvcc` into a shared library with a
C interface, keyed by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags; the host library with `g++ -march=native`,
keyed by a hash of its source, the compiler, the flags and what
-march=native resolves to on this machine (each machine builds for
itself). Both go into
`codegraph_tpu_torch/_build/` (ignored by git) and are loaded with ctypes.
A library is written to a temporary file and put in place with
`os.replace`, so processes that build at once each load a whole library.
Nothing here runs at import time: the first call builds. A failed build
raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import re
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
HOST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")
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


def find_cxx() -> str:
    """The host compiler: $CXX, else g++ on PATH."""
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"host compiler {cxx!r} not found (set CXX); the host "
                           "library cannot be built")
    return found


def native_target(cxx: str) -> str:
    """What -march=native compiles for on this machine, as the compiler
    resolves it (`-Q --help=target`: the architecture and every target
    option)."""
    proc = subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True,
                          text=True, timeout=60)
    return proc.stdout


def host_cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo; where that says
    "unknown" (some virtual machines hide it), its vendor, family and model
    numbers and the architecture that -march=native resolves to."""
    try:
        with open("/proc/cpuinfo") as f:
            text = f.read()
    except OSError:
        text = ""
    info = {}
    for line in text.splitlines():
        key, _, value = line.partition(":")
        info.setdefault(key.strip(), value.strip())
    name = info.get("model name", "")
    if name and name != "unknown":
        return name
    march = re.search(r"-march=\s+(\S+)", native_target(find_cxx()))
    ids = " ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model") if k in info)
    return f"{ids or platform.machine()} (-march=native: {march.group(1) if march else 'unknown'})"


def library_path(name: str, nvcc: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join((nvcc,) + NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def host_library_path(name: str, cxx: str) -> Path:
    src = (CSRC_DIR / f"{name}.cpp").read_bytes()
    key = hashlib.sha256(src + " ".join((cxx,) + HOST_FLAGS + (native_target(cxx),)).encode())
    return BUILD_DIR / f"lib{name}-host-{key.hexdigest()[:16]}.so"


def _compile(cmd, src: Path, so: Path) -> Path:
    """Run `cmd -o <tmp> src` unless `so` exists, then put the library in
    place; the compiler's output is kept beside it (.log)."""
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([*cmd, "-o", str(tmp), str(src)], capture_output=True,
                              text=True, timeout=BUILD_TIMEOUT_S, check=True)
    except subprocess.CalledProcessError as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{os.path.basename(cmd[0])} failed to build {src.name} (exit {exc.returncode}):\n"
            f"{exc.stdout}\n{exc.stderr}") from exc
    except OSError as exc:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} could not be run to build {src.name}: {exc}") from exc
    log = tmp.with_suffix(".log.tmp")
    log.write_text(proc.stdout + proc.stderr)
    os.replace(log, so.with_suffix(".log"))
    os.replace(tmp, so)
    return so


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless a library for this source exists.
    Returns the library's path; nvcc's output is kept beside it (.log)."""
    nvcc = find_nvcc()
    return _compile([nvcc, *NVCC_FLAGS], CSRC_DIR / f"{name}.cu", library_path(name, nvcc))


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with the host compiler for this machine's CPU
    unless a library for this source exists. Returns the library's path."""
    cxx = find_cxx()
    return _compile([cxx, *HOST_FLAGS], CSRC_DIR / f"{name}.cpp",
                    host_library_path(name, cxx))


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


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for csrc/<name>.cpp, built on first use."""
    with _lock:
        lib = _loaded.get(f"{name}.cpp")
        if lib is None:
            lib = ctypes.CDLL(str(build_host(name)))
            _loaded[f"{name}.cpp"] = lib
        return lib


__all__ = ["build", "build_all", "build_host", "build_log", "find_cxx", "find_nvcc",
           "host_cpu_model", "load", "load_host"]

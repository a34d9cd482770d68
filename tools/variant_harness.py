"""The steps the kernel variant tools (tools/*_variants.py) share, on one
NVIDIA GPU: build each variant of a CUDA source from csrc/ with its text
changes (one nvcc each, in parallel, with the shipped flags), load a built
library in place of the shipped one with the variant's host constants, time
every variant in turns (forward, then backward), and print the verdict.

A variant is (text substitutions, host constants, ...): each substitution
applies to the first of the tool's sources that holds its anchor; the other
headers of csrc/ are copied as they are.
"""

import ctypes
import json
import subprocess
import sys
import threading

import torch

import chip_smoke as cs
from codegraph_tpu_torch.ops import cuda_build


def start() -> bool:
    """The card's line, TF32 off; False (and a message) without a GPU."""
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    return True


def chosen(variants: dict, only: str) -> list:
    """The variants named in `only` (comma-separated), or all of them."""
    return [n for n in variants if not only or n in only.split(",")]


def build_one(d, subs, sources, entries, tail: str = ""):
    """Build sources[0] with `subs` applied (and `tail` appended) into
    directory d: (ptxas lines of the kernels whose names hold one of
    `entries`, library path), or (the error, None)."""
    d.mkdir(parents=True, exist_ok=True)
    srcs = {f: (cuda_build.CSRC_DIR / f).read_text() for f in sources}
    for h in cuda_build.CSRC_DIR.glob("*.cuh"):
        srcs.setdefault(h.name, h.read_text())
    for a, b in subs:
        hit = [f for f in sources if a in srcs[f]]
        if not hit:
            return f"anchor not found: {a!r}", None
        srcs[hit[0]] = srcs[hit[0]].replace(a, b)
    srcs[sources[0]] += tail
    for f, text in srcs.items():
        (d / f).write_text(text)
    so = d / f"lib{sources[0].rsplit('.', 1)[0]}.so"
    r = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                        str(d / sources[0])],
                       capture_output=True, text=True, timeout=cuda_build.BUILD_TIMEOUT_S)
    if r.returncode:
        return r.stderr[-2000:], None
    return [ln for ln in cs.ptxas_summary(r.stdout + r.stderr)
            if any(e in ln.split(":")[0] for e in entries)], str(so)


def build_all(names, variants: dict, sources, entries, subdir: str) -> dict:
    """Build every named variant under _build/<subdir>/<i>/ at once and print
    its ptxas lines (or its error); returns name -> library path of those
    that built."""
    out: dict = {}

    def one(i, n):
        out[n] = build_one(cuda_build.BUILD_DIR / subdir / str(i), variants[n][0], sources,
                           entries)

    threads = [threading.Thread(target=one, args=(i, n)) for i, n in enumerate(names)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in names:
        print(json.dumps({"variant": n, "ptxas": out[n][0]}), flush=True)
    return {n: out[n][1] for n in names if out[n][1]}


def in_turns(built: dict, lib: str, owner, run, constants: dict, module=None,
             handle: str = "_lib_handle"):
    """run(name) for each built variant, forward then backward, each with its
    library loaded as csrc/<lib>.cu's (`owner` caches it in `handle`) and
    its host constants (constants[name]) set on `module` (default: owner);
    the shipped library and constants come back after."""
    module = owner if module is None else module
    saved = {a: getattr(module, a) for c in constants.values() for a in c}
    names = list(built)
    try:
        for n in names + names[::-1]:
            cuda_build._loaded[lib] = ctypes.CDLL(built[n])
            setattr(owner, handle, None)
            for a, v in {**saved, **constants[n]}.items():
                setattr(module, a, v)
            run(n)
    finally:
        cuda_build._loaded.pop(lib, None)
        setattr(owner, handle, None)
        for a, v in saved.items():
            setattr(module, a, v)


def report(chosen_names, built: dict, ms: dict, bad: dict, checked: dict, extra=None) -> int:
    """One JSON line per timed variant; exit code 1 if a chosen variant was
    not built or a checked one disagreed."""
    for n in built:
        print(json.dumps({"variant": n, "ms": ms[n],
                          "mismatches_outside_ties": bad[n] if checked[n] else "not checked",
                          **((extra or {}).get(n) or {})}),
              flush=True)
    if len(built) < len(chosen_names):
        print(f"not timed (no anchor or no build): {sorted(set(chosen_names) - set(built))}",
              file=sys.stderr, flush=True)
        return 1
    return 0 if all(v == 0 for n, v in bad.items() if checked[n]) else 1

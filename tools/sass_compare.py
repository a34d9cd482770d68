#!/usr/bin/env python3
"""Show that a change to the CUDA sources changes no generated code: build
csrc/<name>.cu of this checkout and of another csrc/ directory with the
shipped nvcc flags (all at once), and compare the SASS (`cuobjdump -sass`,
mangled names replaced, since they hold a hash of the source's path) and
the ptxas lines, on a machine with the CUDA toolkit.

    python3 tools/sass_compare.py OTHER_CSRC_DIR [NAME ...]   # default: every .cu
    python3 tools/sass_compare.py OTHER_CSRC_DIR NAME --kernel REGEX [--kernel ...]

Without --kernel every kernel of each source is compared. With it only the
kernels whose mangled names match REGEX (a `re.search` pattern) are, each
paired with the one of the same name on the other side; `OTHER=THIS`
pairs the one kernel matching OTHER there with the one matching THIS here
(a kernel that became a template instance, say). A kernel that one side
adds or drops beside them is then not compared. For example, against the
parent commit unpacked with `git archive` into a git-ignored directory.
Prints one line per source or kernel and, last, SASS_SAME or SASS_DIFFER
(exit 0 or 1); writes the libraries and their SASS under
codegraph_tpu_torch/_build/sass/.
"""

import argparse
import difflib
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from codegraph_tpu_torch.ops import cuda_build  # noqa: E402

OUT = cuda_build.BUILD_DIR / "sass"


def _code(lines) -> list:
    return [ln.strip() for ln in lines if ln.strip().startswith(("/*", "Function", ".text"))]


def build(tag: str, csrc: pathlib.Path, name: str):
    """({kernel's mangled name: its SASS lines}, ptxas lines) of
    csrc/<name>.cu, or (None, the error)."""
    so = OUT / f"{tag}_{name}.so"
    r = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                        str(csrc / f"{name}.cu")], capture_output=True, text=True)
    if r.returncode:
        return None, r.stderr[-3000:]
    cuobjdump = pathlib.Path(cuda_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    (OUT / f"{tag}_{name}.sass").write_text(sass)
    kernels, cur = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            cur = m.group(1)
            kernels[cur] = []
        elif cur is not None:
            kernels[cur].append(re.sub(r"_Z\w+", "SYM", ln))
    return {k: _code(v) for k, v in kernels.items()}, cs.ptxas_summary(r.stdout + r.stderr)


def _diff(label: str, a: list, b: list) -> bool:
    print(label, f"SASS lines {len(a)} and {len(b)},", "identical" if a == b else "differ")
    if a != b:
        print("\n".join(list(difflib.unified_diff(a, b, lineterm="", n=1))[:40]))
    return a == b


def _pairs(other: dict, this: dict, spec: str) -> list:
    """[(label, other's SASS, this's SASS)] for one --kernel spec."""
    if "=" in spec:
        left, right = spec.split("=", 1)
        o = [k for k in other if re.search(left, k)]
        t = [k for k in this if re.search(right, k)]
        if len(o) != 1 or len(t) != 1:
            raise SystemExit(f"--kernel {spec}: {len(o)} and {len(t)} kernels match, not 1 and 1")
        return [(f"{left} -> {right}", other[o[0]], this[t[0]])]
    key = lambda name: re.search(spec + r"\w*", name).group(0)  # noqa: E731
    o = {key(k): v for k, v in other.items() if re.search(spec, k)}
    t = {key(k): v for k, v in this.items() if re.search(spec, k)}
    if not o or set(o) != set(t):
        raise SystemExit(f"--kernel {spec}: kernels {sorted(o)} there, {sorted(t)} here")
    return [(name, o[name], t[name]) for name in sorted(o)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=pathlib.Path)
    ap.add_argument("names", nargs="*")
    ap.add_argument("--kernel", action="append", default=[],
                    help="compare only the kernels matching this regex (OTHER=THIS: a renamed one)")
    args = ap.parse_args()
    names = args.names or sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(tag, d, n) for tag, d in (("other", args.other), ("this", cuda_build.CSRC_DIR))
            for n in names]
    with ThreadPoolExecutor(len(jobs)) as ex:
        got = dict(zip([(t, n) for t, _, n in jobs], ex.map(lambda a: build(*a), jobs)))
    same = True
    for n in names:
        (so, po), (sn, pn) = got[("other", n)], got[("this", n)]
        if so is None or sn is None:
            print(n, "build failed:", po if so is None else pn)
            same = False
            continue
        if args.kernel:
            for spec in args.kernel:
                for label, a, b in _pairs(so, sn, spec):
                    same &= _diff(f"{n} {label}:", a, b)
            continue
        a = [ln for k in so for ln in [f"Function : {k}"] + so[k]]
        b = [ln for k in sn for ln in [f"Function : {k}"] + sn[k]]
        a, b = [re.sub(r"_Z\w+", "SYM", ln) for ln in a], [re.sub(r"_Z\w+", "SYM", ln) for ln in b]
        same &= _diff(n, a, b) & (po == pn)
        print(n, "| ptxas", "identical" if po == pn else "differ")
        if po != pn:
            print(" ptxas here:", pn)
    print("SASS_SAME" if same else "SASS_DIFFER")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Show that a change to the CUDA sources changes no generated code: build
csrc/<name>.cu of this checkout and of another csrc/ directory with the
shipped nvcc flags (all at once), and compare the SASS of every kernel
(`cuobjdump -sass`, mangled names replaced, since they hold a hash of the
source's path) and the ptxas lines, on a machine with the CUDA toolkit.

    python3 tools/sass_compare.py OTHER_CSRC_DIR [NAME ...]   # default: every .cu

For example, against the parent commit unpacked with `git archive` into a
git-ignored directory. Prints one line per source and, last, SASS_SAME or
SASS_DIFFER (exit 0 or 1); writes the libraries and their SASS under
codegraph_tpu_torch/_build/sass/.
"""

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


def build(tag: str, csrc: pathlib.Path, name: str):
    """(SASS lines, ptxas lines) of csrc/<name>.cu, or (None, the error)."""
    so = OUT / f"{tag}_{name}.so"
    r = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                        str(csrc / f"{name}.cu")], capture_output=True, text=True)
    if r.returncode:
        return None, r.stderr[-3000:]
    cuobjdump = pathlib.Path(cuda_build.find_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    sass = re.sub(r"_Z\w+", "SYM", sass)
    (OUT / f"{tag}_{name}.sass").write_text(sass)
    lines = [ln.strip() for ln in sass.splitlines()
             if ln.strip().startswith(("/*", "Function", ".text"))]
    return lines, cs.ptxas_summary(r.stdout + r.stderr)


def main() -> int:
    other = pathlib.Path(sys.argv[1])
    names = sys.argv[2:] or sorted(p.stem for p in cuda_build.CSRC_DIR.glob("*.cu"))
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(tag, d, n) for tag, d in (("other", other), ("this", cuda_build.CSRC_DIR))
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
        ok = so == sn and po == pn
        print(n, f"SASS lines {len(so)} and {len(sn)},",
              "identical" if so == sn else "differ", "| ptxas", "identical" if po == pn else "differ")
        if not ok:
            print("\n".join(list(difflib.unified_diff(so, sn, lineterm="", n=1))[:40]))
            print(" ptxas here:", pn)
        same &= ok
    print("SASS_SAME" if same else "SASS_DIFFER")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

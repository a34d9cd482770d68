#!/usr/bin/env python3
"""Run chip_smoke.py's phases 8, 9 and 10 several times on one NVIDIA GPU,
each time under another temporary directory, and show how often the card
and the CPU keep different candidates at a search's cut.

    python3 tools/cut_tie_stress.py [--runs N] [--phases 8,9,10]

These phases index a copy of the repo's `codegraph_tpu/`, and the text each
node is embedded with names its file's absolute path, so every run embeds a
slightly different corpus. The card's bf16 encoder and the CPU's differ by
~1e-4 in a score; where two candidates tie that closely at a cut (the
3 x limit chunk prefetch, or the top-limit nodes), the two sides can keep
different ones, and the graph boost, normalised over the candidates, then
moves every score of that search. chip_smoke.py counts such a search as a
cut tie (`_cut_tie`) instead of holding it position by position.

Prints the card, then one JSON line per (run, phase): whether the phase
passed, every search whose verdict was not "same" (query, limit,
verdict), and every search that the rule before cut ties would have
failed (query, mismatches outside ties, id mismatches, max abs error).
Each search's verdict is taken, also where its results agree.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--phases", default="8,9,10")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("cut_tie_stress: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    cur = {}
    cut, unless, payload_close = cs._cut_tie, cs._unless_cut_tie, cs._payload_close

    def logged_cut(searches, query, limit, *a, **k):
        v = cut(searches, query, limit, *a, **k)
        cur["verdicts"].append([query, limit, v])
        return v

    def logged_unless(r, searches, query, limit, filters=(None, None), tol=cs.ENC_TOL):
        out = unless(r, searches, query, limit, filters, tol)
        if r["mismatches_outside_ties"]:
            cur["old_rule"].append([query, r["mismatches_outside_ties"], r["id_mismatches"],
                                    r["max_abs_err"]])
        else:
            cs._cut_tie(searches, query, limit, filters, tol)
        return out

    def logged_payload_close(got, ref, tol, cut_tie=None, params=None):
        out = payload_close(got, ref, tol, cut_tie, params)
        if cut_tie is not None:
            pairs = ([(got, ref, params)] if "results" in got else
                     [(e["result"], f["result"], e["params"]) for e, f in
                      zip(got.get("evidence", []), ref.get("evidence", []))
                      if "results" in e["result"]])
            for g, r, p in pairs:
                old = cs._tool_close(g, r, tol)
                if old["mismatches_outside_ties"]:
                    cur["old_rule"].append([p["query"], old["mismatches_outside_ties"],
                                            old["id_mismatches"], old["max_abs_err"]])
                else:
                    cut_tie(p)
        return out

    cs._cut_tie, cs._unless_cut_tie = logged_cut, logged_unless
    cs._payload_close = logged_payload_close
    cs.phase0(torch)
    from codegraph_tpu_torch.index import ivf, ivfpq
    from codegraph_tpu_torch.ops import quantize, topk

    mods = {"topk": topk, "quantize": quantize, "ivfpq": ivfpq, "ivf": ivf}
    errs = {n: 0.0 for n in cs.KERNELS}
    phases = [int(p) for p in args.phases.split(",")]
    base = tempfile.mkdtemp(prefix="cut_tie_stress_")
    for i in range(args.runs):
        # another path length each run: another corpus
        tempfile.tempdir = os.path.join(base, "run" + "x" * (3 * i))
        os.makedirs(tempfile.tempdir)
        for ph in phases:
            cur.clear()
            cur.update(run=i, phase=ph, verdicts=[], old_rule=[])
            t0 = time.perf_counter()
            try:
                getattr(cs, f"phase{ph}")(torch, mods, errs)
                cur["ok"] = True
            except Exception as e:  # a failed phase is a result here
                cur["ok"], cur["error"] = False, repr(e)[:2000]
            cur["seconds"] = round(time.perf_counter() - t0, 1)
            cur["verdicts"] = [v for v in cur["verdicts"] if v[2] != "same"]
            print(json.dumps(cur), flush=True)
    tempfile.tempdir = None
    shutil.rmtree(base, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the timed window, the check, the result.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (`setup_s`, from the start of the process) imports the port, makes
the corpus on the card from the seed and adds it through the tier's own
`add` after `reserve(N)`, makes the query set, and warms every shape the
cell's traffic sends (the first run in a checkout also builds the kernels,
into `codegraph_tpu_torch/_build/`). The window then runs the cell's mix
for `--seconds`, after one full collection of the set-up's garbage; the
heap is not frozen, since no serving process of the port freezes it.
With `--trace 1` the window runs under `torch.profiler`. After it the
program's index is freed and the reference judges every answer
(`reference/check.py`). The last lines on standard error give each number
compared beside its limit; the last line on standard output is the result.

A cell's metrics are those `BENCHMARK.json` gives it: its end-to-end ones
with `--trace 0`, its per-layer ones with `--trace 1`, each read by
`metrics/<name>.py` from what the run recorded. A reader that finds
nothing returns None and its metric is left out.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import re
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
ROOT = PKG_DIR.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
#: top-level modules a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "codegraph_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named_file(folder: str, name: str, suffix: str) -> Path:
    if not NAME.fullmatch(name):
        raise ValueError(f"{name!r} is not a name")
    path = PKG_DIR / folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{folder}/{name}{suffix} not found")
    return path


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int = 1


def resolve(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files: workload,
    configuration, mix, and the metrics that apply to it."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise ValueError(f"BENCHMARK.json has no workload {name!r}")
    spec = load_json(_named_file("workloads", name, ".json"))
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} {spec[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")

    def applies(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name=name,
        config=load_json(_named_file("configs", entry["config"], ".json")),
        traffic=load_json(_named_file("traffic", entry["traffic"], ".json")),
        limits=spec["limits"],
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
        chips=int(entry["chips"]),
    )


def metric_reader(name: str) -> Callable:
    """`read(run)` of metrics/<name>.py."""
    path = _named_file("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + re.sub(r"\W", "_", name),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def build_tier(config: dict, device):
    """The configuration's tier, as its users build it."""
    tier = config["tier"]
    cls = getattr(importlib.import_module(tier["module"]), tier["class"])
    return cls(config["dim"], device=str(device), **tier["kwargs"])


@dataclass
class Run:
    """What one run recorded, for the metric readers."""
    cell: Cell
    seconds: float
    setup_s: float
    outcome: object
    calls: List[tuple]
    recall: float
    window_peak_bytes: Optional[int]
    trace: object = None

    def calls_in_window(self) -> List[tuple]:
        o = self.outcome
        return [c for c in self.calls if o.t_start <= c[1] <= o.t_end]


def forbidden_modules() -> List[str]:
    """Forbidden top-level modules that this process holds, by whole name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool = False, device="cuda",
             t0: Optional[float] = None, make_index: Optional[Callable] = None,
             wrap: Optional[Callable] = None) -> dict:
    """One run of `cell`; returns the result's fields and `checks`.
    `make_index(config, device)` replaces the tier (the control);
    `wrap(index)` puts a layer between the traffic and the tier (tests)."""
    import torch

    from portbench import data
    from portbench.drive import ClosedLoop, TimedIndex
    from portbench.reference.check import judge

    t0 = time.perf_counter() if t0 is None else t0
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = cell.config
    n_rows, dim, k = int(cfg["n_rows"]), int(cfg["dim"]), int(cfg["k"])

    stages = {"imports_s": time.perf_counter() - t0}

    def stage(name: str) -> None:
        if on_card:
            torch.cuda.synchronize(dev)
        stages[name] = time.perf_counter() - t0 - sum(stages.values())

    with torch.no_grad():
        torch.zeros(1, device=dev)
        stage("device_init_s")
        mixture = data.GaussianMixture(cfg["generator"], dim, seed, dev)
        index = (make_index or build_tier)(cfg, dev)
        index.reserve(n_rows)
        for _, rows in mixture.blocks(n_rows):
            index.add(rows)
            del rows
        stage("corpus_s")
        pool = mixture.queries(int(cfg["queries"])).cpu().numpy()
    order = data.query_order(seed, len(pool))
    proxy = TimedIndex(wrap(index) if wrap else index)
    loop = ClosedLoop(cell.traffic, index, proxy, pool, order, k)
    stage("queries_s")
    loop.warm()
    stage("warm_s")
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0

    # Every window starts from the same collector state: the set-up's garbage gone.
    gc.collect()
    gc_before = [s["collections"] for s in gc.get_stats()]
    tracer = None
    if trace:
        from portbench.trace import Tracer

        tracer = Tracer()
        with tracer:
            outcome = loop.run(seconds, annotate=True)
    else:
        outcome = loop.run(seconds)
    window_peak = peak = None
    if on_card:
        torch.cuda.synchronize(dev)
        window_peak = torch.cuda.max_memory_allocated(dev)
        peak = max(setup_peak, window_peak)
    gc_during = [s["collections"] - b for s, b in zip(gc.get_stats(), gc_before)]
    loop.close()
    calls = list(proxy.calls)
    parsed = tracer.read(outcome.t_start, seconds, calls) if tracer is not None else None
    del loop, proxy, index, tracer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    qi, times, scores, ids = outcome.answers.arrays()
    key = np.concatenate([qi[:, None], ids, scores.view(np.int32)], axis=1)
    distinct, which = np.unique(key, axis=0, return_inverse=True)
    checks, recall_u = judge(cfg, mixture, pool, distinct[:, 0], distinct[:, 1:k + 1],
                             distinct[:, k + 1:].copy().view(np.float32), dev)
    checks["bad_answers"] += (outcome.answers.misshapen + len(outcome.errors)
                              + outcome.unanswered)
    counted = times[:, 1] <= outcome.t_end
    recall = float(recall_u[which.reshape(-1)[counted]].mean()) if counted.any() else float("nan")

    run = Run(cell=cell, seconds=seconds, setup_s=setup_s, outcome=outcome, calls=calls,
              recall=recall, window_peak_bytes=window_peak, trace=parsed)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    limits = {name: {"value": checks[name], "limit": float(limit)}
              for name, limit in cell.limits.items()}
    correct = len(qi) > 0 and all(v["value"] <= v["limit"] for v in limits.values())
    result = {
        "correct": correct,
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed + len(outcome.errors) + outcome.unanswered),
        "metrics": metrics,
        "device": device_info(dev, peak),
    }
    if parsed is not None:
        from portbench.trace import breakdown

        result["device"]["busy_s"] = parsed.busy_s()
        result["device"]["window_s"] = parsed.window_s
        outside = "client loop" if cell.traffic["via"] == "index" else "service, no search open"
        result["breakdown"] = breakdown(parsed, outside)
    result["setup_stages"] = stages
    result["window_stats"] = window_stats(run, gc_during)
    result["checks"] = limits
    return result


def window_stats(run: Run, gc_during: List[int]) -> dict:
    """What a reader of the run's spread wants beside its metrics: answers
    in each second of the window, the tier calls by rows passed, the
    collections of Python's garbage collector in the window, and what
    failed (the first errors raised, as text)."""
    o = run.outcome
    done = o.times()[:, 1] - o.t_start
    per_second = np.bincount(done[done <= run.seconds].astype(int),
                             minlength=int(np.ceil(run.seconds)))
    rows: Dict[int, int] = {}
    for c in run.calls_in_window():
        rows[c[0]] = rows.get(c[0], 0) + 1
    return {"answers_per_second": per_second.tolist(), "calls_by_rows": rows,
            "gc_collections": gc_during, "shed_or_timed_out": o.failed,
            "unanswered": o.unanswered, "misshapen": o.answers.misshapen,
            "errors": o.errors[:3]}


def device_info(dev, peak) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(peak)}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              f"--id={dev.index or 0}"], capture_output=True, text=True, timeout=20)
        info["power_limit"] = smi.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return info


def parse_args(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_count_error(chips: int) -> Optional[str]:
    """Why this process cannot run a cell of `chips` cards, or None."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is False: the benchmark runs only on a card"
    if torch.cuda.device_count() < chips:
        return f"the cell needs {chips} cards, this machine has {torch.cuda.device_count()}"
    return None


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    cell = resolve(args.workload)
    why = card_count_error(cell.chips)
    if why:
        print(f"portbench: {why}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0=t0)
    held = forbidden_modules()
    if held:
        print(f"portbench: the run loaded {', '.join(held)}", file=sys.stderr)
        return 3
    print("setup " + json.dumps(result.pop("setup_stages")), file=sys.stderr)
    print("window " + json.dumps(result.pop("window_stats")), file=sys.stderr)
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


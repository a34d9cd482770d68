"""Readings of the numbers that decide `correct`, over many seeds in one
process: the program's (to set each limit's lower reading) or, with
`--control 1`, the control's (`reference/control.py`, its upper reading).

    python portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 10 [--control 1]

Each seed is one whole run of the cell (set-up, window, check), as
`run.py` makes it; a line of JSON per seed goes to standard output. The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from portbench.harness import card_count_error, resolve, run_cell
    from portbench.reference.control import ControlIndex

    cell = resolve(args.workload)
    why = card_count_error(cell.chips)
    if why:
        print(f"readings: {why}", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result = run_cell(cell, seed, args.seconds, t0=t0,
                          make_index=ControlIndex if args.control else None)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": {k: v["value"] for k, v in result["checks"].items()},
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "setup_stages": result["setup_stages"],
                          "window_stats": result["window_stats"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.exit(main(sys.argv[1:]))

"""Run one cell of the port's benchmark on this machine's card.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Exits 2 without a card, 3 if the run
loaded JAX or the JAX package; the last line of standard output is the
result (see `portbench/harness.py`).
"""

import sys
import time

T0 = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], T0))

"""The benchmark's command: one run of one cell on one CUDA card.

    python3 hfxbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints its notes and the numbers it
compared on standard error, and one JSON line last on standard output.
Exits with another code than 0, printing no result, when the machine
has fewer CUDA cards than the cell asks for, or when the process has
loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()   # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from hfxbench import harness

    return harness.main(argv, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())

"""One run of one benchmark cell, from the root of a checkout:

    python3 perfbench/run.py --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

Prints the run's result as one JSON line, the last line of its standard
output, and each number compared with its limit as the last lines of its
standard error.  See perfbench/README.md.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main() -> None:
    root = Path(__file__).resolve().parents[1]
    # the checkout's root, not this folder: its module names would shadow
    sys.path[0:1] = [str(root), str(root / "src")]
    from perfbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))


if __name__ == "__main__":
    main()

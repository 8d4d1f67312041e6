"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout (the program's package beside this
folder) on a machine with the cell's CUDA devices; see harness.py.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the port's benchmark once and print its result line.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs a CUDA card (the cell's chip count); without one it exits non-zero
and prints no result. See slambench/README.md.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slambench.harness.core import main, setup_env  # noqa: E402

if __name__ == "__main__":
    setup_env()
    sys.exit(main())

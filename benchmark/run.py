#!/usr/bin/env python3
"""The benchmark of svpc_torch on one NVIDIA card (see benchmark/pbench/cli.py):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from pbench.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(T_START))

"""The host side of a run, kept the same from run to run: fixed thread
counts for the math libraries, the load generator on a core of its own
apart from the server's, and a probe of the host's speed printed before
and after the window, so that a slow run can be told from a slow host.
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Tuple

THREADS = 4  # torch's and the math libraries' CPU threads
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def fix_threads() -> None:
    """Before torch is imported: every run the same CPU thread counts."""
    for var in THREAD_VARS:
        os.environ[var] = str(THREADS)


def split_cores() -> Tuple[List[int], List[int]]:
    """(the harness's and the program's cores, the load generator's): the
    last core of this process's set for the load generator where there are
    four or more, all of them for both otherwise."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return cores, cores
    return cores[:-1], cores[-1:]


def pin(cores: List[int]) -> None:
    """This thread, and every thread it starts from now on, to ``cores``."""
    os.sched_setaffinity(0, cores)


def probe(when: str) -> None:
    """Time a fixed piece of interpreter work and a 64 MiB copy on this
    host, on standard error."""
    import numpy as np
    t = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i * i
    python_ms = (time.perf_counter() - t) * 1e3
    a = np.ones(1 << 24, np.float32)
    t = time.perf_counter()
    b = a.copy()
    copy_gbs = a.nbytes / (time.perf_counter() - t) / 1e9
    del a, b
    print(f"host probe {when}: a fixed interpreter loop {python_ms:.1f} ms, "
          f"a 64 MiB copy {copy_gbs:.2f} GB/s", file=sys.stderr)

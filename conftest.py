"""Shared setup for running svpc_tpu's 8-device JAX tests side by side
under pytest-xdist (`-n 6`). pytest loads this file before
tests/conftest.py, so what it puts in the environment is there before
jax is first imported; tests/conftest.py keeps the collective timeouts
set here because XLA_FLAGS already names them.
"""

import faulthandler
import os

import pytest

# XLA:CPU runs the thunks of all 8 devices on one intra-op pool, whose
# size PJRT_NPROC sets (default: the host's cores). A device can start
# independent collectives in another order than its peers, and each one
# holds a pool thread while it waits for them. On an 8-core host, 8
# threads filled up: 7 waited in the pipeline's 8-device collective
# permute and 1 in a tp all-reduce, so the devices still missing from
# each got no thread, and the program waited forever at 0% CPU
# (tests/test_zero1.py::test_zero1_composes_with_pp[2], dp2 x pp2 x tp2).
# 32 threads hold 4 blocked collectives a device.
os.environ["PJRT_NPROC"] = "32"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_cpu_collective_call_terminate_timeout_seconds" not in flags:
    # XLA:CPU aborts the process (SIGABRT) when a collective's participants
    # have not all arrived after warn + terminate seconds. On an 8-core
    # host running 6 xdist workers of 8 virtual devices each, no live
    # collective of the whole suite waited 5 s; one that waits 2 minutes
    # is stuck, and the abort ends only its worker
    flags += (" --xla_cpu_collective_call_warn_stuck_timeout_seconds=60"
              " --xla_cpu_collective_call_terminate_timeout_seconds=60")
os.environ["XLA_FLAGS"] = flags.strip()

# svpc_tpu's tests that run programs on all 8 virtual devices
MULTIDEVICE_FILES = frozenset({"test_accum.py", "test_multistep.py",
                               "test_parallel.py", "test_pipeline.py",
                               "test_zero1.py"})
# seconds the call of one of their items may take before its worker dumps
# every thread's stack and exits: about twice the longest item
MULTIDEVICE_ITEM_LIMIT_S = 750
_STDERR = pytest.StashKey()


def pytest_configure(config):
    # fd 2 is the process's own stderr here; while an item runs, pytest
    # captures it into a file that is lost if the process exits
    config.stash[_STDERR] = os.fdopen(os.dup(2), "w")
    # --dist load sends each worker runs of consecutive items, so the
    # 8-device items, which take most of the run, queued up behind each
    # other on one worker. Handed out one at a time and first, they spread
    # over the workers, and the short items fill in at the end.
    if getattr(config.option, "maxschedchunk", 0) is None:
        config.option.maxschedchunk = 1


def pytest_collection_modifyitems(items):
    items.sort(key=lambda item: item.path.name not in MULTIDEVICE_FILES)


def pytest_unconfigure(config):
    config.stash[_STDERR].close()


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    """Bound the call of an 8-device item. A collective that never
    completes waits inside XLA's C++ and never returns to Python, so no
    signal handler would run: faulthandler's watchdog thread dumps every
    thread's stack and exits the process. xdist then reports the item as
    failed, starts a new worker and the run goes on.

    faulthandler has one timer, which pytest's `faulthandler_timeout`
    also uses: during the call the limit replaces it, and after the call
    it is armed again, for the teardown."""
    if item.path.name not in MULTIDEVICE_FILES:
        yield
        return
    out = item.config.stash[_STDERR]
    faulthandler.dump_traceback_later(MULTIDEVICE_ITEM_LIMIT_S, exit=True,
                                      file=out)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        if item.config.pluginmanager.has_plugin("faulthandler"):
            timeout = float(item.config.getini("faulthandler_timeout") or 0)
            if timeout > 0:
                faulthandler.dump_traceback_later(timeout, file=out)

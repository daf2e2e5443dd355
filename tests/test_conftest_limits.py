"""The repo's root conftest.py: the per-item limit on the 8-device files,
in a pytest subprocess over a planted test file in a copy of the repo's
test setup, and XLA:CPU's thread pool and collective timeouts, where the
JAX tests run."""

import os
import re
import shutil
import subprocess
import sys
import textwrap

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def test_item_over_limit_dumps_stacks_fails_alone(tmp_path):
    """An item of an 8-device file that outlasts the limit (3 s here)
    leaves every thread's stack in the output and one failed item; its
    worker is replaced and the item after it passes."""
    (tmp_path / "tests").mkdir()
    shutil.copy(os.path.join(REPO, "pyproject.toml"), tmp_path)
    shutil.copy(os.path.join(HERE, "conftest.py"), tmp_path / "tests")
    conftest, n = re.subn(r"^MULTIDEVICE_ITEM_LIMIT_S = .*$",
                          "MULTIDEVICE_ITEM_LIMIT_S = 3",
                          open(os.path.join(REPO, "conftest.py")).read(),
                          flags=re.M)
    assert n == 1
    (tmp_path / "conftest.py").write_text(conftest)
    (tmp_path / "tests" / "test_zero1.py").write_text(textwrap.dedent("""
        import time

        def test_a_waits_past_the_limit():
            time.sleep(120)

        def test_b_after_it():
            pass
        """))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-p", "xdist",
         "-p", "no:cacheprovider", "-p", "no:randomly",
         "-n", "1", "--dist", "load", "-rf"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 1, out[-3000:]
    assert "Timeout (0:00:03)!" in out, out[-3000:]
    assert "in test_a_waits_past_the_limit" in out, out[-3000:]
    assert "1 failed, 1 passed" in out, out[-3000:]
    assert "FAILED tests/test_zero1.py::test_a_waits_past_the_limit" in out


def _thread_names():
    names = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                names.append(f.read().strip())
        except FileNotFoundError:  # the thread ended meanwhile
            pass
    return names


def test_xla_cpu_pool_and_collective_timeouts_in_force():
    """Where the JAX tests run, XLA:CPU's intra-op pool has the root
    conftest's 32 threads (with the host's 8, the 8-device collectives
    of test_zero1_composes_with_pp[2] deadlocked), and a stuck collective
    aborts after 60 + 60 s, not tests/conftest.py's 300 + 600."""
    import jax
    import jax.numpy as jnp

    flags = os.environ["XLA_FLAGS"].split()
    assert "--xla_cpu_collective_call_warn_stuck_timeout_seconds=60" in flags
    assert "--xla_cpu_collective_call_terminate_timeout_seconds=60" in flags
    assert sum("collective_call" in f for f in flags) == 2, flags
    total = jax.pmap(lambda v: jax.lax.psum(v, "i"), axis_name="i")(
        jnp.arange(8.0))
    assert total.tolist() == [28.0] * 8
    assert _thread_names().count("tf_XLAEigen") == 32

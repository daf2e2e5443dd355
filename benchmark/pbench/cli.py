"""One run of one cell:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up, a window of ``--seconds``, then the reference check; the last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number compared with its limit), and the last
lines of standard error repeat the checks.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics.

``--control bf16`` runs the program at ``compute_dtype=bfloat16`` (the
precision below the configuration's float32) and ``--fault`` plants one
of the faults the check must catch; they serve the proof of the check,
and the benchmark's own runs use neither.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional, Tuple

from pbench import host
from pbench.spec import ROOT, Cell, load_benchmark

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "svpc_tpu")


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    workdir: str
    t_start: float
    model_cfg: object = None
    control: Optional[str] = None
    fault: Optional[str] = None
    loadgen_cores: Optional[list] = None

    @property
    def config(self) -> Dict:
        return self.cell.config

    @property
    def traffic(self) -> Dict:
        return self.cell.traffic

    def mark(self, what: str) -> None:
        """Where set-up has got to, on standard error."""
        print(f"set-up: {what} at {time.monotonic() - self.t_start:.3f} s",
              file=sys.stderr)


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``svpc_torch`` is not ``svpc_tpu``)."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def model_config(c: Dict, control: Optional[str]):
    from svpc_torch.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg = ModelConfig(**{k: v for k, v in c.items() if k in names})
    if control == "bf16":
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    return cfg


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e300


def execute(ctx: Context) -> Tuple[Dict, list]:
    """Run the cell; -> (the result line's object, the check lines)."""
    ctx.model_cfg = model_config(ctx.config, ctx.control)
    kind = ctx.traffic["kind"]
    if kind == "serve":
        from pbench import serve as driver
    elif kind == "train":
        from pbench import train as driver
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    record = driver.run(ctx)
    record["trace_on"] = ctx.trace
    metrics = ctx.cell.metrics(record, ctx.trace)
    checks = {}
    for name, limit in ctx.cell.limits.items():
        value = (record["failed"] if name == "failed_requests"
                 else record["checks"][name])
        checks[name] = {"value": _finite(float(value)), "limit": limit}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    device = _device(ctx, record)
    out = {"correct": correct, "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics, "device": device}
    if ctx.trace and record["trace"] is not None:
        t = record["trace"]
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"],
                            "idle_gaps": t["idle_gaps"]}
    out["checks"] = checks
    lines = [f"compared {n}: {v!r}" for n, v in record["checks"].items()
             if n not in checks]
    lines += [f"check {n}: {v['value']!r} (limit {v['limit']!r})"
              for n, v in checks.items()]
    return out, lines


def _device(ctx: Context, record: Dict) -> Dict:
    import torch
    dev = ctx.device
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
           "count": 1, "memory_peak_bytes": record["memory_peak_bytes"]}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits",
                            f"--id={dev.index or 0}"],
                           capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(q.stdout.strip())
    except (OSError, ValueError, subprocess.TimeoutExpired):
        pass
    return out


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("bf16",), default=None)
    p.add_argument("--fault", choices=("token", "half_batch", "unchanged"),
                   default=None)
    return p.parse_args(argv)


def main(t_start: float, argv=None) -> int:
    args = parse(argv)
    host.fix_threads()
    own_cores, loadgen_cores = host.split_cores()
    host.pin(own_cores)
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton_cache")
    cell = Cell(args.workload, load_benchmark())
    import torch
    torch.set_num_threads(host.THREADS)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    workdir = tempfile.mkdtemp(prefix="pbench_")
    try:
        ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device=torch.device("cuda", 0),
                      workdir=workdir, t_start=t_start, control=args.control,
                      fault=args.fault, loadgen_cores=loadgen_cores)
        out, lines = execute(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


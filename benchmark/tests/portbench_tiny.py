"""Helpers of the benchmark's CPU tests: a benchmark tree at its
architectures' tiny sizes whose cells run the real harness."""

import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
TINY_TRAFFIC = dict(pool_videos=8, segments=[2, 4], segments_mean=3.0,
                    segment_s_mean=3.0, video_s_mean=14.0, ingredients=[1, 3],
                    feature_files=3, batch_videos=2, max_clips=4,
                    check_requests=4, clients=4, warmup_steps=2)
# an open loop, which the load generator keeps for a later cell
OPEN_TRAFFIC = dict(loop="open", rate_per_s=20.0, senders=8)


def make_tiny_root(path) -> str:
    """A copy of the benchmark's data files at tiny sizes under ``path``:
    BENCHMARK.json (with a cell of open-loop arrivals, which the load
    generator keeps for a later cell), each configuration cut by its
    architecture's ``tiny``, the traffic files cut to a pool of 8 short
    videos, the limits; the metric readers and the architectures are
    copies of the real ones."""
    from pbench.spec import load_architecture
    root = str(path)
    b = os.path.join(root, "benchmark")
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(b, d))
    for d in ("metrics", "arch"):
        shutil.copytree(os.path.join(BENCH, d), os.path.join(b, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append(dict(
        name="vivt-serve-open", config="vivt", traffic="open", chips=1,
        why="open-loop arrivals"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "vivt-serve-flood" in m.get("workloads", []):
            m["workloads"].append("vivt-serve-open")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for entry in bench["configs"]:
        with open(os.path.join(ROOT, entry["file"])) as f:
            c = json.load(f)
        with open(os.path.join(root, entry["file"]), "w") as f:
            json.dump(load_architecture(root, c)[1].tiny(c), f)
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        with open(os.path.join(BENCH, "traffic", name)) as f:
            t = json.load(f)
        t.update({k: v for k, v in TINY_TRAFFIC.items()
                  if k in t or k == "check_requests"})
        with open(os.path.join(b, "traffic", name), "w") as f:
            json.dump(t, f)
    with open(os.path.join(b, "traffic", "flood.json")) as f:
        t = json.load(f)
    with open(os.path.join(b, "traffic", "open.json"), "w") as f:
        json.dump(dict(t, **OPEN_TRAFFIC), f)
    for name in os.listdir(os.path.join(BENCH, "limits")):
        shutil.copy(os.path.join(BENCH, "limits", name),
                    os.path.join(b, "limits", name))
    shutil.copy(os.path.join(b, "limits", "vivt-serve-flood.json"),
                os.path.join(b, "limits", "vivt-serve-open.json"))
    return root


def run_tiny(root, workload, tmp_path, seed=2 ** 31 + 7, seconds=2.0,
             fault=None):
    """One CPU run of ``workload`` in the tiny tree -> (result, lines)."""
    import time
    import torch
    from pbench.cli import Context, execute
    from pbench.spec import Cell, load_benchmark
    work = tmp_path / f"work_{workload}_{fault}"
    work.mkdir()
    ctx = Context(cell=Cell(workload, load_benchmark(root), root=root),
                  seed=seed, seconds=seconds, trace=False,
                  device=torch.device("cpu"), workdir=str(work),
                  t_start=time.monotonic(), fault=fault)
    return execute(ctx)

"""The harness finds each cell's configuration, traffic, limits and
metric readers by name; a new configuration, traffic mix, metric and cell
come as new files and new BENCHMARK.json entries, with no existing file
edited; and nothing the benchmark runs loads JAX or the JAX package."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from pbench.cli import FORBIDDEN, forbidden_modules
from pbench.serve import Hooks
from pbench.spec import Cell, load_benchmark
from portbench_tiny import BENCH, ROOT


def test_cells_find_their_files_by_name():
    bench = load_benchmark(ROOT)
    for w in bench["workloads"]:
        cell = Cell(w["name"], bench, root=ROOT)
        # the cell's architecture builds the program's configuration from
        # the file (SVPC: ModelConfig.validate, model_mode among its
        # modes), and every setting of the file that the program has
        # reaches it unchanged
        cfg = cell.arch.model_config(cell.config, None)
        for key, value in cell.config.items():
            if hasattr(cfg, key):
                assert getattr(cfg, key) == value, key
        assert set(cell.arch.tiny(cell.config)) >= set(cell.config)
        kind = cell.traffic["kind"]
        assert kind in ("serve", "train")
        assert cell.hooks is cell.arch.KINDS[kind]
        if kind == "serve":
            assert isinstance(cell.hooks, Hooks)
        else:
            assert callable(cell.hooks)
        assert cell.limits
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        assert "setup_s" in names
        for m in names:
            assert callable(cell.reader(m))


def _snapshot(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_new_config_traffic_metric_and_cell_are_only_added(tmp_path):
    root = str(tmp_path / "tree")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _snapshot(os.path.join(root, "benchmark"))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "vivt.json")) as f:
        c = json.load(f)
    with open(os.path.join(b, "configs", "viv.json"), "w") as f:
        json.dump(dict(c, model_mode="reason_copy"), f)
    with open(os.path.join(b, "traffic", "flood.json")) as f:
        t = json.load(f)
    with open(os.path.join(b, "traffic", "burst.json"), "w") as f:
        json.dump(dict(t, clients=32), f)
    with open(os.path.join(b, "limits", "viv-serve-burst.json"), "w") as f:
        json.dump({"failed_requests": 0, "logprob_gap": 1e-3}, f)
    with open(os.path.join(b, "metrics", "serve.requests.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run['latencies_ms']))"
                "\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="viv",
                                 file="benchmark/configs/viv.json"))
    bench["workloads"].append(dict(name="viv-serve-burst", config="viv",
                                   traffic="burst", chips=1, why="a test"))
    bench["per_layer"].append(dict(
        name="serve.requests", unit="requests", better="higher",
        source="program_counter", layer="a test", moves="setup_s",
        workloads=["viv-serve-burst"]))
    next(m for m in bench["end_to_end"] if m["name"] ==
         "memory_peak_mib.serve")["workloads"].append("viv-serve-burst")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _snapshot(b)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    cell = Cell("viv-serve-burst", load_benchmark(root), root=root)
    assert cell.config["model_mode"] == "reason_copy"
    assert cell.traffic["clients"] == 32
    run = {"latencies_ms": [1.0, 2.0], "kind": "serve",
           "clips_in_window": 4, "window_s": 2.0, "setup_s": 1.0,
           "memory_peak_bytes": 2 ** 20}
    got = cell.metrics(run, trace=True)
    assert got == {"serve.requests": {"value": 2.0, "unit": "requests"}}
    assert set(cell.metrics(run, trace=False)) == {
        "setup_s", "memory_peak_mib.serve"}


def test_top_level_names_compare_whole():
    assert forbidden_modules({"svpc_torch.serving": 1, "jaxtyping": 1,
                              "flaxen": 1}) == []
    assert forbidden_modules({"jax.numpy": 1, "svpc_tpu": 1}) == \
        ["jax", "svpc_tpu"]


def _imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            yield node.module


def test_no_benchmark_file_imports_or_names_jax():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            tops = {m.split(".")[0] for m in _imported(path)}
            assert not tops & set(FORBIDDEN), path
            with open(path) as fh:
                text = fh.read()
            for name in FORBIDDEN:
                for bad in (f"import {name}\n", f"import {name}.",
                            f"from {name} ", f"from {name}.",
                            f"import_module(\"{name}"):
                    assert bad not in text, (path, bad)


def test_load_generator_imports_only_the_standard_library():
    tops = {m.split(".")[0] for m in _imported(
        os.path.join(BENCH, "pbench", "loadgen.py"))}
    assert tops <= {"__future__", "http", "json", "os", "queue", "sys",
                    "threading", "time"}


@pytest.mark.parametrize("module", ["pbench.cli", "pbench.serve",
                                    "pbench.train", "pbench.check"])
def test_harness_process_loads_no_jax(module):
    code = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]; "
            f"import {module}, svpc_torch.serving, svpc_torch.train.loop; "
            "from pbench.cli import forbidden_modules; "
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"

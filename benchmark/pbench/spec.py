"""Everything of one cell, found by name: its entry in BENCHMARK.json,
the configuration file it names, its traffic file
(``benchmark/traffic/<mix>.json``), the limits of its correctness check
(``benchmark/limits/<cell>.json``) and a reader for each metric it
reports (``benchmark/metrics/<metric>.py``, a function ``read(run)`` of
the run's record that returns the number, or None where the run has
nothing to read)."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class Cell:
    def __init__(self, name: str, bench: Dict, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(has {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.config = json.load(f)
        bench_dir = os.path.join(root, "benchmark")
        with open(os.path.join(bench_dir, "traffic",
                               f"{self.workload['traffic']}.json")) as f:
            self.traffic = json.load(f)
        with open(os.path.join(bench_dir, "limits", f"{name}.json")) as f:
            self.limits = json.load(f)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]
        self.metrics_dir = os.path.join(bench_dir, "metrics")

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        path = os.path.join(self.metrics_dir, f"{metric}.py")
        spec = importlib.util.spec_from_file_location(
            "pbench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def metrics(self, run: Dict, trace: bool) -> Dict[str, Dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        metrics (``trace`` true) that the run's record has."""
        out = {}
        for m in (self.per_layer if trace else self.end_to_end):
            value = self.reader(m["name"])(run)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def load_benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def list_cells(bench: Dict) -> List[str]:
    return [w["name"] for w in bench["workloads"]]

"""Everything of one cell, found by name: its entry in BENCHMARK.json,
the configuration file it names, the architecture that file names
(``benchmark/arch/<name>.py``, ``svpc`` where the file names none), its
traffic file (``benchmark/traffic/<mix>.json``), the limits of its
correctness check (``benchmark/limits/<cell>.json``) and a reader for each
metric it reports (``benchmark/metrics/<metric>.py``, a function
``read(run)`` of the run's record that returns the number, or None where
the run has nothing to read).

An architecture module gives ``model_config(c, control)`` (the program's
configuration object for the configuration file ``c``, with ``--control
bf16`` applied; it has ``compute_dtype``), ``tiny(c)`` (the file cut to the
CPU tests' sizes), and ``KINDS``, which maps each traffic kind it runs to
that kind's entry: ``serve`` to a ``pbench.serve.Hooks`` that the shared
serving window calls, ``train`` to a function ``run(ctx)`` that returns
the run's record.  The entries are checked when the cell is built.

One hazard binds every architecture that serves: torch.profiler started
or stopped while another thread replays a CUDA graph can deadlock both.
The profiled slice starts and stops the profiler holding ``Spans.quiet``,
and ``Spans.wrap`` holds it around each call it times, so a call that may
replay graphs has to run inside one of the spans ``Hooks.install`` puts
in (the decode's, as a rule).

A second architecture comes as a new file there and new entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
DEFAULT_ARCHITECTURE = "svpc"


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
        self.architecture, self.arch = load_architecture(root, self.config)
        kind = self.traffic["kind"]
        kinds = getattr(self.arch, "KINDS", {})
        if kind not in kinds:
            raise ValueError(
                f"architecture {self.architecture!r} does not run traffic "
                f"of kind {kind!r} (cell {name!r}); it runs {sorted(kinds)}")
        # serve: the window's hooks; train: run(ctx)
        self.hooks = kinds[kind]
        _check_entry(self.architecture, kind, self.hooks)
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]
        self.metrics_dir = os.path.join(bench_dir, "metrics")

    def reader(self, metric: str) -> Callable[[Dict], Optional[float]]:
        path = os.path.join(self.metrics_dir, f"{metric}.py")
        return _load(path, "pbench_metric_" + metric.replace(".", "_")).read

    def metrics(self, run: Dict, trace: bool) -> Dict[str, Dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        metrics (``trace`` true) that the run's record has."""
        out = {}
        for m in (self.per_layer if trace else self.end_to_end):
            value = self.reader(m["name"])(run)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def _load(path: str, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_architecture(root: str, config: Dict) -> Tuple[str, ModuleType]:
    """The name of the architecture that configuration ``config`` names
    (``svpc`` where it names none) and its module, loaded from
    ``<root>/benchmark/arch/``; an unknown name raises, listing the
    architectures there."""
    name = config.get("architecture", DEFAULT_ARCHITECTURE)
    arch_dir = os.path.join(root, "benchmark", "arch")
    path = (os.path.join(arch_dir, f"{name}.py") if isinstance(name, str)
            and re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]{0,63}", name) else None)
    if path is None or not os.path.isfile(path):
        present = sorted(f[:-3] for f in os.listdir(arch_dir)
                         if f.endswith(".py"))
        raise ValueError(f"no architecture {name!r} in benchmark/arch/ "
                         f"(has {present})")
    return name, _load(path, f"pbench_arch_{name}")


def _check_entry(architecture: str, kind: str, entry) -> None:
    """Refuses an entry of ``KINDS`` that is not of its kind's form."""
    from pbench.serve import Hooks
    forms = {"serve": (lambda e: isinstance(e, Hooks),
                       "a pbench.serve.Hooks"),
             "train": (callable, "a function run(ctx)")}
    if kind not in forms:
        raise ValueError(f"no traffic kind {kind!r} in the harness "
                         f"(has {sorted(forms)})")
    ok, form = forms[kind]
    if not ok(entry):
        raise ValueError(f"architecture {architecture!r}: KINDS[{kind!r}] "
                         f"is {type(entry).__name__}, not {form}")


def load_benchmark(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def list_cells(bench: Dict) -> List[str]:
    return [w["name"] for w in bench["workloads"]]

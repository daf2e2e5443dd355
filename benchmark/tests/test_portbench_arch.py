"""A second model architecture comes as new files and entries only: its
module under benchmark/arch/, a configuration file that names it, limits,
a per-layer reader and BENCHMARK.json entries.  Its serving cell then runs
whole through the shared window at tiny sizes on the CPU, reaching the
program only through that module.  A configuration that names an absent
architecture, a traffic kind its architecture lacks, or an entry not of
its kind's form, is refused when the cell is built, before any set-up."""

import copy
import json
import os
import time

import pytest

from pbench.spec import Cell, load_benchmark
from portbench_tiny import ROOT, make_tiny_root

# The program's video-only model, built in the module's own code; every
# hook notes that it ran.
TOY = '''"""A test architecture: svpc_torch's video-only model."""
import dataclasses
import json

import numpy as np

from pbench import flops
from pbench.serve import Hooks

CALLED = []


def model_config(c, control):
    CALLED.append("model_config")
    from svpc_torch.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in c.items() if k in names})


def tiny(c):
    return dict(c)


def build(ctx, fx):
    CALLED.append("build")
    import svpc_torch.serving as serving
    from svpc_torch.config import Config, DataConfig
    from svpc_torch.model import SVPCModel
    from pbench.weights import make_weights
    cfg = Config(model=ctx.model_cfg, data=DataConfig(
        video_feature_dir=fx["video_feature_dir"],
        duration_file=fx["duration_file"],
        word2idx_path=fx["word2idx_path"],
        verb2idx_path=fx["verb2idx_path"]))
    model = SVPCModel(cfg.model).to(ctx.device)
    model.load_state_dict(make_weights(ctx.config, ctx.seed, ctx.device))
    return serving.CaptionService(cfg, model, device=ctx.device,
                                  batch_videos=ctx.traffic["batch_videos"],
                                  max_clips=ctx.traffic["max_clips"])


def install(ctx, svc, served, rec, spans, calls):
    CALLED.append("install")
    import svpc_torch.serving as serving
    b2s = serving.batch_to_sentences

    def batch_to_sentences(out, metas, vocab):
        if rec["on"]:
            served.extend((m["name"], np.array(out[i, :m["n_steps"]]))
                          for i, m in enumerate(metas))
        return b2s(out, metas, vocab)

    def remove():
        CALLED.append("remove")
        serving.batch_to_sentences = b2s

    serving.batch_to_sentences = batch_to_sentences
    return remove


def video_flops(c, frames, entities, ingredient_tokens):
    if CALLED[-1] != "video_flops":
        CALLED.append("video_flops")
    return flops.encode_flops(c, frames, entities, ingredient_tokens)


def slice_readings(calls):
    CALLED.append("slice_readings")
    return {}


def check(ctx, fx, served):
    CALLED.append("check")
    from pbench.check import reference_model, served_gap
    with open(fx["word2idx_path"]) as f:
        word2idx = json.load(f)
    model = reference_model(ctx.config, ctx.seed, ctx.device).eval()
    gaps = [served_gap(model, ctx.config, fx, name, tokens, word2idx,
                       ctx.device) for name, tokens in served[:4]]
    return {"toy_gap": max(gaps), "toy_requests": float(len(gaps))}


KINDS = {"serve": Hooks(build=build, install=install,
                       video_flops=video_flops,
                       slice_readings=slice_readings, check=check)}
'''
READER = '''def read(run):
    return float(run["model_flops"]) if run.get("trace_on") else None
'''


def _snapshot(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            if "__pycache__" not in p:
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    return out


def _add_toy(root, architecture="toy", traffic="flood", module=TOY):
    """The toy architecture's files and entries, added to the tree at
    ``root``; -> the name of its cell."""
    b = os.path.join(root, "benchmark")
    name = f"toy-{traffic}"
    with open(os.path.join(b, "arch", "toy.py"), "w") as f:
        f.write(module)
    with open(os.path.join(b, "metrics", "serve.toy_flops.py"), "w") as f:
        f.write(READER)
    with open(os.path.join(b, "configs", "v.json")) as f:
        c = json.load(f)
    with open(os.path.join(b, "configs", "toy.json"), "w") as f:
        json.dump(dict(c, architecture=architecture), f)
    with open(os.path.join(b, "limits", f"{name}.json"), "w") as f:
        json.dump({"failed_requests": 0, "toy_gap": 1e-3}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="toy",
                                 file="benchmark/configs/toy.json"))
    bench["workloads"].append(dict(name=name, config="toy", traffic=traffic,
                                   chips=1, why="a test"))
    bench["per_layer"].append(dict(
        name="serve.toy_flops", unit="flop", better="higher",
        source="program_counter", layer="a test",
        moves="memory_peak_mib.serve", workloads=[name]))
    serving = next(m for m in bench["end_to_end"]
                   if m["name"] == "memory_peak_mib.serve")
    serving["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return name


def test_second_architecture_serves_as_new_files_only(tmp_path,
                                                      monkeypatch):
    import torch
    from pbench import check, flops
    from pbench.cli import Context, execute
    root = make_tiny_root(tmp_path / "tree")
    b = os.path.join(root, "benchmark")
    before = _snapshot(b)
    bench_before = load_benchmark(root)
    name = _add_toy(root)
    after = _snapshot(b)
    assert all(after[k] == v for k, v in before.items())  # nothing edited
    assert set(after) - set(before) == {
        "arch/toy.py", "configs/toy.json", "limits/toy-flood.json",
        "metrics/serve.toy_flops.py"}
    # BENCHMARK.json: the old entries as they were, the new ones appended
    bench = load_benchmark(root)
    added = copy.deepcopy(bench)
    added["configs"].pop()
    added["workloads"].pop()
    added["per_layer"].pop()
    assert next(m for m in added["end_to_end"] if m["name"] ==
                "memory_peak_mib.serve")["workloads"].pop() == name
    assert added == bench_before

    # SVPC's serving pieces must not be reached
    def svpc_reached(*args, **kwargs):
        raise AssertionError("an SVPC serving hook ran")
    monkeypatch.setattr(check, "check_serving", svpc_reached)
    monkeypatch.setattr(flops, "serve_video_flops", svpc_reached)
    cell = Cell(name, bench, root=root)
    assert cell.architecture == "toy"
    work = tmp_path / "work"
    work.mkdir()
    ctx = Context(cell=cell, seed=2 ** 31 + 11, seconds=2.0, trace=False,
                  device=torch.device("cpu"), workdir=str(work),
                  t_start=time.monotonic())
    out, lines = execute(ctx)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["checks"]) == {"failed_requests", "toy_gap"}
    assert out["checks"]["toy_gap"]["value"] <= 1e-5
    assert "compared toy_requests: 4.0" in lines
    # the card's memory peak reads nothing on the CPU
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "memory_peak_mib.serve"]
    assert set(out["metrics"]) == {"setup_s"}
    assert cell.arch.CALLED == ["model_config", "build", "install", "remove",
                                "video_flops", "check"]
    assert cell.metrics({"model_flops": 5, "trace_on": True}, trace=True) \
        == {"serve.toy_flops": {"value": 5.0, "unit": "flop"}}


def _configurations_without_architecture_run_as_svpc(root):
    bench = load_benchmark(root)
    plain = 0
    for w in bench["workloads"]:
        cell = Cell(w["name"], bench, root=root)
        if "architecture" not in cell.config:
            plain += 1
            assert cell.architecture == "svpc"
            assert os.path.basename(cell.arch.__file__) == "svpc.py"
        else:
            assert cell.architecture == cell.config["architecture"]
            assert os.path.basename(cell.arch.__file__) == \
                f"{cell.architecture}.py"
    return plain


def test_configurations_without_architecture_run_as_svpc(tmp_path):
    assert _configurations_without_architecture_run_as_svpc(ROOT) >= 1
    # a second architecture's entries leave the rule as it was
    root = make_tiny_root(tmp_path / "tree")
    plain = _configurations_without_architecture_run_as_svpc(root)
    _add_toy(root)
    assert _configurations_without_architecture_run_as_svpc(root) == plain


# the toy whose serving entry is the window's function, not its hooks
MISFORMED = TOY.replace('KINDS = {"serve": Hooks(',
                        'KINDS = {"serve": build, "unused": Hooks(')


@pytest.mark.parametrize("architecture,traffic,module,named", [
    ("absent", "flood", TOY, ["'absent'", "'svpc'", "'toy'"]),
    ("../arch/toy", "flood", TOY, ["'../arch/toy'"]),
    ("toy", "train", TOY, ["'toy'", "'train'", "['serve']"]),
    ("toy", "flood", MISFORMED, ["'toy'", "'serve'", "pbench.serve.Hooks"]),
])
def test_cell_is_refused_before_setup(tmp_path, architecture, traffic,
                                      module, named):
    root = make_tiny_root(tmp_path / "tree")
    name = _add_toy(root, architecture=architecture, traffic=traffic,
                    module=module)
    with pytest.raises(ValueError) as err:
        Cell(name, load_benchmark(root), root=root)
    for word in named:
        assert word in str(err.value)

"""Whole runs of the harness at tiny sizes on the CPU: the result line's
schema, the frozen reference agreeing with the program's CPU path on the
served tokens and on three training steps, and ``correct`` coming out
false with the timed path broken underneath (a token altered where it is
produced; half of the batch left out, the mean taken over the rest; a
step that leaves its state unchanged).  The look for a card is skipped:
the runs call the harness below ``main``."""

import json

import pytest

from portbench_tiny import run_tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _schema(out, lines, e2e):
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    json.loads(json.dumps(out))
    assert set(out["metrics"]) == set(e2e)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(out["device"])
    for name, v in out["checks"].items():
        assert set(v) == {"value", "limit"}
        assert any(line.startswith(f"check {name}:") for line in lines)
    assert lines[-1].startswith("check ")


# end-to-end metrics a CPU run reports: the card's memory peak reads
# nothing there (test_memory_peak_is_read_from_the_card)
@pytest.mark.parametrize("workload,e2e", [
    ("vivt-serve-flood", ["setup_s"]),
    ("v-serve-flood", ["setup_s"]),
    ("vivt-serve-open", ["setup_s"]),
])
def test_serving_run_matches_the_reference(tiny_root, tmp_path, workload,
                                           e2e):
    out, lines = run_tiny(tiny_root, workload, tmp_path)
    _schema(out, lines, e2e)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["logprob_gap"]["value"] <= 1e-5


def test_training_run_matches_the_reference(tiny_root, tmp_path):
    out, lines = run_tiny(tiny_root, "vivt-train", tmp_path)
    _schema(out, lines, ["train_clips_per_s", "setup_s"])
    assert out["correct"], out["checks"]
    for v in out["checks"].values():
        assert v["value"] <= 1e-5


@pytest.mark.parametrize("workload,fault,caught", [
    ("vivt-serve-flood", "token", "logprob_gap"),
    ("v-serve-flood", "token", "logprob_gap"),
    ("vivt-train", "half_batch", "loss_gap"),
    ("vivt-train", "unchanged", "change_gap"),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, tmp_path, workload,
                                            fault, caught):
    out, _ = run_tiny(tiny_root, workload, tmp_path, fault=fault)
    assert not out["correct"]
    c = out["checks"][caught]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("workload,kind", [
    ("vivt-serve-flood", "serve"), ("v-serve-flood", "serve"),
    ("vivt-train", "train")])
def test_memory_peak_is_read_from_the_card(tiny_root, workload, kind):
    from pbench.spec import Cell, load_benchmark
    cell = Cell(workload, load_benchmark(tiny_root), root=tiny_root)
    run = dict(kind=kind, setup_s=1.0, clips_in_window=8, window_s=2.0,
               memory_peak_bytes=786674176)
    (name,) = [m for m in cell.metrics(run, trace=False)
               if m.startswith("memory_peak_mib")]
    assert cell.metrics(run, trace=False)[name] == {"value": 750.23095703125,
                                                    "unit": "MiB"}
    run["memory_peak_bytes"] = 0  # a CPU run
    assert name not in cell.metrics(run, trace=False)

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


@pytest.mark.parametrize("workload", ["vivt-serve-flood", "v-serve-flood",
                                      "vivt-serve-open"])
def test_serving_run_matches_the_reference(tiny_root, tmp_path, workload):
    out, lines = run_tiny(tiny_root, workload, tmp_path)
    _schema(out, lines, ["serve_clips_per_s", "setup_s"])
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

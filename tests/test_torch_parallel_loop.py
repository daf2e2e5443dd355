"""svpc_torch's CLIs on a gloo mesh of CPU ranks (each a process, started
as torchrun starts them: svpc_torch.parallel.worker.run_ranks): ``cli.
train --dp_size 2 --zero1 --multihost_sharded_data`` gives the one-rank
history and its checkpoint resumes on one rank (and the other way
round); ``cli.evaluate --dp_size 2 --tp_size 2`` gives the one-rank
captions; ``--pp_size 2`` is refused.  Tiny geometry on a training
fixture (8 train videos, batch 2; 4 val videos).

The trainer packs each dp block on its own, so a dp run's clip rows are
not a one-rank run's: the training runs turn the clip-level dropout off
and use ``viv`` (no Gumbel draws), leaving the reasoner's per-video
dropout on, which both draw alike.  Losses agree within 1e-5 relative,
counts and captions exactly."""

import json
import os

import pytest
import torch

torch.set_num_threads(1)

GEOMETRY = ["--hidden_size", "32", "--intermediate_size", "32",
            "--lstm_hidden_size", "32", "--num_attention_heads", "4",
            "--num_hidden_layers", "1", "--word_vec_size", "16",
            "--video_feature_size", "24", "--max_v_len", "10",
            "--max_t_len", "8", "--max_i_len", "20"]
RANK_TIMEOUT = 60
ENV = {"OMP_NUM_THREADS": "1"}


def _fixture(root):
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data.synthetic import write_training_fixture

    fx = write_training_fixture(str(root / "data"), tiny_test_config("full"),
                                n_train=8, n_val=4, seed=0, max_clips=4)
    return ["--data_dir", fx["data_dir"],
            "--video_feature_dir", fx["video_feature_dir"],
            "--duration_file", fx["duration_file"],
            "--word2idx_path", fx["word2idx_path"],
            "--verb2idx_path", fx["verb2idx_path"],
            "--max_n_sen", "4", "--device", "cpu"]


def _train_argv(data):
    return data + GEOMETRY + [
        "--model_type", "viv", "--hidden_dropout_prob", "0",
        "--attention_probs_dropout_prob", "0", "--batch_size", "2",
        "--val_batch_size", "2", "--lr", "1e-3", "--no_tensorboard"]


def _assert_same_epoch(got, want):
    for part in ("train", "val"):
        for key in ("loss_per_word", "acc"):
            assert got[part][key] == pytest.approx(want[part][key],
                                                   rel=1e-5), (part, key)
        for key in ("entity", "action"):
            assert got[part][key] == pytest.approx(want[part][key],
                                                   rel=1e-6), (part, key)
    assert got["lang"] == pytest.approx(want["lang"], rel=1e-6)


def test_dp2_zero1_train_matches_one_rank_and_resumes_across_layouts(
        tmp_path):
    """A (1 rank) and B (dp2, ZeRO-1, per-rank data, two optimizer steps a
    call: the stacked batches' dp blocks) train epoch 0 alike;
    B's checkpoint resumes on 1 rank (C) and A's on dp2 ZeRO-1 (D), and
    C's and D's epoch 1 agree, their final parameters within rtol 2e-4 /
    atol 1e-5.  Rank 0 alone writes."""
    from svpc_torch.cli.train import main as train_main
    from svpc_torch.parallel.worker import run_ranks

    argv = _train_argv(_fixture(tmp_path))
    dp2 = ["--dp_size", "2", "--zero1", "--multihost_sharded_data"]
    wd = {k: str(tmp_path / k) for k in "ab"}

    def two_ranks(extra, name):
        run_ranks(["svpc_torch.cli.train", *argv, *dp2, *extra], 2,
                  RANK_TIMEOUT, str(tmp_path / f"logs_{name}"), ENV)

    def history(w):
        with open(os.path.join(w, "history.json")) as f:
            return json.load(f)

    train_main(argv + ["--n_epoch", "1", "--workdir", wd["a"]])
    two_ranks(["--n_epoch", "1", "--workdir", wd["b"],
               "--steps_per_dispatch", "2"], "b")
    _assert_same_epoch(history(wd["b"])[0], history(wd["a"])[0])
    with open(os.path.join(wd["b"], "train.log.csv")) as f:
        assert len(f.readlines()) == 2   # header + epoch 0, written once

    # C: B's dp2 ZeRO-1 checkpoint on 1 rank; D: A's on dp2 ZeRO-1
    train_main(argv + ["--n_epoch", "2", "--workdir", wd["b"],
                       "--resume_from", wd["b"] + "/checkpoint_last"])
    two_ranks(["--n_epoch", "2", "--workdir", wd["a"], "--resume_from",
               wd["a"] + "/checkpoint_last"], "d")
    c, d = history(wd["b"]), history(wd["a"])
    assert [h["epoch"] for h in c] == [h["epoch"] for h in d] == [0, 1]
    _assert_same_epoch(d[1], c[1])
    ckpt = {k: torch.load(os.path.join(w, "checkpoint_last"),
                          weights_only=True) for k, w in wd.items()}
    assert ckpt["a"]["step"] == ckpt["b"]["step"] == 8
    for group in ("model", "ema_shadow"):
        for n, want in ckpt["b"][group].items():
            torch.testing.assert_close(ckpt["a"][group][n], want,
                                       rtol=2e-4, atol=1e-5, msg=n)
    for n, want in ckpt["b"]["optimizer"]["m"].items():
        assert ckpt["a"]["optimizer"]["m"][n].shape == want.shape, n


def test_evaluate_dp2_tp2_gives_one_rank_captions(tmp_path):
    """cli.evaluate on 4 ranks (dp2 x tp2: 2 of the 4 heads a rank, the
    vocabulary split, half the eval batch a dp rank) writes the
    one-rank submission, sentence for sentence: greedy, and beam K=2
    with two ranked hypotheses (the beam's cache gathers reorder this
    rank's heads only)."""
    from svpc_torch.cli.evaluate import main as evaluate_main
    from svpc_torch.cli.train import main as train_main
    from svpc_torch.parallel.worker import run_ranks

    data = _fixture(tmp_path)
    workdir = str(tmp_path / "run")
    train_main(data + GEOMETRY + ["--batch_size", "2", "--n_epoch", "1",
                                  "--lr", "1e-3", "--no_tensorboard",
                                  "--workdir", workdir])
    argv = data + ["--checkpoint", workdir + "/checkpoint_last",
                   "--split", "val", "--val_batch_size", "3"]
    entries = lambda sub: {v: [(e["sentence"], [h["sentence"] for h in
                                                e.get("nbest", [])])
                               for e in es]
                           for v, es in sub["results"].items()}
    for name, extra in (("greedy", []),
                        ("beam2_n2", ["--use_beam", "--beam_size", "2",
                                      "--n_best", "2"])):
        one = evaluate_main(argv + extra + [
            "--output_dir", str(tmp_path / "one")])
        run_ranks(["svpc_torch.cli.evaluate", *argv, *extra,
                   "--output_dir", str(tmp_path / "mesh"), "--dp_size", "2",
                   "--tp_size", "2"], 4, RANK_TIMEOUT,
                  str(tmp_path / f"logs_{name}"), ENV)
        with open(tmp_path / "mesh" / f"{name}_pred_val.json") as f:
            mesh = json.load(f)
        assert entries(mesh) == entries(one["submission"]), name
        assert len(mesh["results"]) == 4


def test_train_refuses_pp(capsys):
    """--pp_size 2 exits with a usage error naming what is not ported."""
    from svpc_torch.cli.train import main as train_main

    with pytest.raises(SystemExit) as e:
        train_main(["--video_feature_dir", "x", "--duration_file", "y",
                    "--workdir", "z", "--pp_size", "2"])
    assert e.value.code == 2
    assert "not ported" in capsys.readouterr().err

"""svpc_torch's scoring path end to end on the CPU, at tiny geometry on a
training fixture with val and test splits and their paragraph references:
``cli.train`` with language eval (CIDEr in valid.log.csv, checkpoint_best
chosen by it) and without it; ``cli.evaluate`` greedy and beam with
``n_best=2`` and ``--ingredient_f1`` on the trainer's own checkpoint, its
metrics equal to svpc_tpu's scorers on the same submission file;
``cli.caption`` against ``CaptionService``; ``cli.serve`` loading the
trainer's checkpoint with beam search."""

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


def _data_argv(fx):
    return ["--data_dir", fx["data_dir"],
            "--video_feature_dir", fx["video_feature_dir"],
            "--duration_file", fx["duration_file"],
            "--word2idx_path", fx["word2idx_path"],
            "--verb2idx_path", fx["verb2idx_path"],
            "--max_n_sen", "4", "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(fixture, workdir, train result) of a 2-epoch cli.train run."""
    from svpc_torch.cli.train import main
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data.synthetic import write_training_fixture

    root = tmp_path_factory.mktemp("eval_cli")
    fx = write_training_fixture(str(root / "data"), tiny_test_config("full"),
                                n_train=6, n_val=3, seed=0,
                                max_clips=4)
    workdir = str(root / "run")
    res = main(_data_argv(fx) + GEOMETRY + [
        "--batch_size", "2", "--val_batch_size", "2", "--n_epoch", "2",
        "--lr", "1e-3", "--workdir", workdir])
    return fx, workdir, res


def test_train_selects_checkpoint_best_by_cider(trained, tmp_path,
                                                monkeypatch):
    """valid.log.csv carries each epoch's METEOR, BLEU@4, CIDEr and re4
    (x100, as history.json's); checkpoint_best holds the first epoch of
    the highest CIDEr above 0.  With the scorer's CIDEr replaced by 0.3,
    0.1, 0.0 over three epochs and patience 0, checkpoint_best is epoch 0
    (whatever the val loss does) and training stops after epoch 1; a
    CIDEr of 0 never wins, so no checkpoint_best is written and training
    stops after epoch 0.  Without language
    eval the columns stay 0, no decode is written and checkpoint_best is
    the lowest val loss."""
    import svpc_torch.train.loop as loop
    from svpc_torch.cli.train import main

    fx, workdir, res = trained
    hist = res["history"]
    with open(os.path.join(workdir, "valid.log.csv")) as f:
        rows = [ln.split(",") for ln in f.read().split()[1:]]
    ciders = [h["lang"]["CIDEr"] for h in hist]
    assert len(rows) == 2 and max(ciders) > 0, ciders
    for row, h in zip(rows, hist):
        for col, key in ((4, "METEOR"), (5, "Bleu_4"), (6, "CIDEr"),
                         (7, "re4")):
            assert float(row[col]) == pytest.approx(
                100 * h["lang"][key], abs=5e-3), key
    best = max(range(2), key=lambda e: (ciders[e], -e))   # never a 0
    payload = torch.load(os.path.join(workdir, "checkpoint_best"),
                         weights_only=True)
    assert payload["epoch"] == best and res["best_cider"] == ciders[best]

    real_eval = loop.evaluate_submission
    for ciders, epochs, best in (([0.3, 0.1, 0.0], [0, 1], 0),
                                 ([0.0, 0.0], [0], None)):
        it = iter(ciders)
        monkeypatch.setattr(loop, "evaluate_submission", lambda sub, refs: dict(
            real_eval(sub, refs), CIDEr=next(it)))
        wd = str(tmp_path / f"cider{len(ciders)}")
        res3 = main(_data_argv(fx) + GEOMETRY + [
            "--batch_size", "2", "--val_batch_size", "2", "--n_epoch",
            str(len(ciders)), "--max_es_cnt", "0", "--workdir", wd])
        assert [h["epoch"] for h in res3["history"]] == epochs
        if best is None:
            assert "checkpoint_best" not in os.listdir(wd)
            assert res3["best_cider"] == 0.0
        else:
            assert torch.load(os.path.join(wd, "checkpoint_best"),
                              weights_only=True)["epoch"] == best
            assert res3["best_cider"] == ciders[best]
    monkeypatch.setattr(loop, "evaluate_submission", real_eval)

    quiet = str(tmp_path / "no_lang")
    res2 = main(_data_argv(fx) + GEOMETRY + [
        "--batch_size", "2", "--val_batch_size", "2", "--n_epoch", "1",
        "--no_language_eval", "--workdir", quiet])
    with open(os.path.join(quiet, "valid.log.csv")) as f:
        assert f.read().split()[1].split(",")[4:] == \
            ["0.00", "0.00", "0.00", "0.00"]
    assert res2["history"][0]["lang"] == {}
    assert "greedy_pred_val_epoch0.json" not in os.listdir(quiet)
    assert "checkpoint_best" in os.listdir(quiet)


def test_evaluate_metrics_equal_svpc_tpu(trained, tmp_path):
    """Greedy on val, beam K=2 n_best=2 with ingredient F1 on test, from
    the trainer's checkpoint_best (EMA weights): the output files, ranked
    nbest entries, and metrics equal to svpc_tpu.evaluation's on the
    written submission."""
    from svpc_tpu.evaluation import evaluate_submission
    from svpc_tpu.evaluation.ingredient_f1 import (
        build_ingredient_dictionary, ingredient_f1)
    from svpc_torch.cli.evaluate import main

    fx, workdir, _ = trained
    ckpt = ["--checkpoint", os.path.join(workdir, "checkpoint_best")]
    for split, extra, name in (
            ("val", [], "greedy"),
            ("test", ["--use_beam", "--beam_size", "2", "--n_best", "2",
                      "--ingredient_f1"], "beam2_n2")):
        out = str(tmp_path / split)
        res = main(_data_argv(fx) + ckpt + [
            "--split", split, "--output_dir", out, "--val_batch_size", "2"]
            + extra)
        assert sorted(os.listdir(out)) == sorted(
            [f"{name}_pred_{split}.json", f"metrics_{split}.json"])
        with open(res["submission_path"]) as f:
            submission = json.load(f)
        with open(res["metrics_path"]) as f:
            metrics = json.load(f)
        assert len(submission["results"]) == 3
        ref = os.path.join(fx["data_dir"],
                           f"yc2_split_{split}_anet_format_para.json")
        want = json.loads(json.dumps(evaluate_submission(submission, [ref]),
                                     default=str))
        if extra:
            entries = [e for v in submission["results"].values() for e in v]
            assert all(len(e["nbest"]) == 2 and e["sentence"] ==
                       e["nbest"][0]["sentence"] and e["nbest"][0]["score"]
                       >= e["nbest"][1]["score"] for e in entries)
            with open(os.path.join(
                    fx["data_dir"],
                    "bosselut_split_yc2_test_anet_format.json")) as f:
                gt = json.load(f)
            want["ingredient_f1"] = ingredient_f1(
                {k: {"ingredients": a["ingredients"],
                     "sentences": a["sentences"]} for k, a in gt.items()},
                {k: {"ingredients": gt[k]["ingredients"],
                     "sentences": [e["sentence"] for e in v]}
                 for k, v in submission["results"].items()},
                build_ingredient_dictionary(fx["data_dir"]))
        assert metrics == want
        for key in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                    "METEOR_backend", "ROUGE_L", "CIDEr", "re1", "re2",
                    "re3", "re4"):
            assert key in metrics, key


def test_caption_and_serve_load_the_trainer_checkpoint(trained, tmp_path):
    """The loader gives the trainer's EMA weights (checkpoint_last against
    the final state's eval_params); cli.caption (greedy and beam) equals
    CaptionService's sentences on the same spec and checkpoint; cli.serve's
    service loads the trainer's checkpoint with --use_beam --n_best 2; an
    orbax directory and a missing checkpoint are refused."""
    from svpc_torch.cli import caption
    from svpc_torch.cli.common import config_from_args, load_checkpoint_model
    from svpc_torch.cli.serve import _parser, build_service
    from svpc_torch.serving import CaptionService

    fx, workdir, res = trained
    ckpt = os.path.join(workdir, "checkpoint_best")
    last = _parser().parse_args(_data_argv(fx) + [
        "--checkpoint", os.path.join(workdir, "checkpoint_last")])
    _, model = load_checkpoint_model(config_from_args(last), last)
    ema = res["state"].eval_params()
    assert ema.keys() == dict(model.named_parameters()).keys()
    assert all(torch.equal(p, ema[n]) for n, p in model.named_parameters())
    with open(os.path.join(fx["data_dir"],
                           "bosselut_split_yc2_test_anet_format.json")) as f:
        spec = {k: {"timestamps": a["timestamps"],
                    "ingredients": a["ingredients"]}
                for k, a in json.load(f).items()}
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    argv = _data_argv(fx) + ["--checkpoint", ckpt]
    args = _parser().parse_args(argv)
    cfg, model = load_checkpoint_model(config_from_args(args), args)
    for beam in ([], ["--use_beam", "--beam_size", "2"]):
        out = caption.main(argv + ["--input_json", spec_path, "--output",
                                   str(tmp_path / "captions.json")] + beam)
        svc = CaptionService(cfg, model, batch_videos=2, warmup=False,
                             beam_size=2 if beam else 0, device="cpu")
        want = svc.caption(spec)
        assert {v: [c["sentence"] for c in clips]
                for v, clips in out.items()} == \
            {v: [c["sentence"] for c in clips] for v, clips in want.items()}

    service, _ = build_service(argv + ["--use_beam", "--n_best", "2",
                                       "--batch_videos", "2"])
    assert service.decoder == "beam2" and service.n_best == 2
    got = service.caption(spec)
    assert all(len(c["nbest"]) == 2 for clips in got.values()
               for c in clips)

    orbax = tmp_path / "orbax_ckpt"
    orbax.mkdir()
    for path, msg in ((str(orbax), "orbax"), (ckpt + "_nope", "not found")):
        with pytest.raises(SystemExit, match=msg):
            build_service(_data_argv(fx) + ["--checkpoint", path])

"""svpc_torch's offline tools against svpc_tpu's on one written fixture, on
the CPU: ``cli.export_checkpoint`` (read back by svpc_tpu's reference
loader), ``cli.dump_memories`` (the same noise handed to both),
``cli.validate_data`` (the same report, clean and broken) and
``cli.convert_features`` (the same bytes)."""

import copy
import filecmp
import json
import logging
import os
import pickle

import numpy as np
import pytest
import torch

from tests.torch_parity import (jax_model, port_model, shared_gumbel_by_shape,
                                to_port)

torch.set_num_threads(1)

MODE = "full"


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    from svpc_torch.data.synthetic import write_training_fixture

    cfg, _ = port_model(MODE)
    root = str(tmp_path_factory.mktemp("tools"))
    return write_training_fixture(root, cfg, n_train=3, n_val=3, seed=4,
                                  min_clips=2, max_clips=4)


def _argv(fx):
    return ["--model_type", "vivt", "--data_dir", fx["data_dir"],
            "--word2idx_path", fx["word2idx_path"],
            "--verb2idx_path", fx["verb2idx_path"],
            "--video_feature_dir", fx["video_feature_dir"],
            "--duration_file", fx["duration_file"]]


def test_export_checkpoint_reads_back_in_svpc_tpu(fixture, tmp_path):
    """A port trainer checkpoint after one step (EMA shadow != params),
    exported raw and with --ema: svpc_tpu's import_reference_checkpoint
    reads each ``.chkpt``, and its parameters, carried back, equal the
    port's state dict (raw) or eval weights (EMA) exactly; the port's
    own reference loader reads the same file."""
    from svpc_torch.cli.export_checkpoint import main as export
    from svpc_torch.data.packing import pack_batch
    from svpc_torch.data.synthetic import synthetic_batch
    from svpc_torch.model.from_jax import (load_reference_checkpoint,
                                           state_dict_from_jax)
    from svpc_torch.train.optim import make_optimizer
    from svpc_torch.train.state import TrainState, save_checkpoint
    from svpc_torch.train.step import train_step
    from svpc_tpu.config import Config as JaxConfig
    from svpc_tpu.model.load_reference import import_reference_checkpoint

    cfg, model = port_model(MODE)
    model = copy.deepcopy(model)
    state = TrainState.create(
        model, make_optimizer(cfg.train, 1, dict(model.named_parameters())),
        use_ema=True)
    with shared_gumbel_by_shape(0):
        train_step(state, to_port(pack_batch(synthetic_batch(cfg, 2, seed=1),
                                             cfg.model.max_t_len)), cfg)
    ckpt = save_checkpoint(str(tmp_path), state, cfg, "checkpoint_best")
    want = {"raw": {n: p.detach() for n, p in state.params.items()},
            "ema": state.eval_params()}
    assert not all(torch.equal(want["raw"][n], want["ema"][n])
                   for n in want["raw"])
    jcfg = JaxConfig().replace_model(max_n_sen=cfg.model.max_n_sen,
                                     max_entities=cfg.model.max_entities,
                                     max_oov=cfg.model.max_oov,
                                     max_ingr_words=cfg.model.max_ingr_words)
    for kind, flags in (("raw", []), ("ema", ["--ema"])):
        out = str(tmp_path / f"{kind}.chkpt")
        export(_argv(fixture) + ["--checkpoint", ckpt, "--out", out] + flags)
        jcfg_out, _, params = import_reference_checkpoint(out, jcfg)
        back = state_dict_from_jax(params, cfg.model)
        _, own = load_reference_checkpoint(out)
        for name, w in want[kind].items():
            assert torch.equal(back[name], w.float()), (kind, name)
            assert torch.equal(own[name], w.float()), (kind, name)
        assert jcfg_out.model.hidden_size == cfg.model.hidden_size


def test_dump_memories_matches_svpc_tpu(fixture, tmp_path):
    """The port's dump_memories against svpc_tpu's on the val split with
    carried weights and the same Gumbel noise: the same recipes and keys,
    every array within 1e-5; cli.dump_memories --device cpu writes the
    pickle of the same dump."""
    from svpc_torch.cli.dump_memories import dump_memories, main
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.model.from_jax import save_reference_checkpoint
    from svpc_tpu.cli.dump_memories import dump_memories as jax_dump
    from svpc_tpu.data.pipeline import CaptionDataset as JaxDataset

    jcfg, jmodel, params = jax_model(MODE)
    cfg, model = port_model(MODE)
    paths = {k: fixture[k] for k in ("data_dir", "word2idx_path",
                                     "verb2idx_path", "duration_file",
                                     "video_feature_dir")}
    cfg = cfg.replace_data(**paths).replace_train(val_batch_size=3)
    jcfg = jcfg.replace_data(**paths).replace_train(val_batch_size=3)
    with shared_gumbel_by_shape(11):
        got = dump_memories(model, CaptionDataset(cfg, "val",
                                                  lazy_features=True), cfg)
        want = jax_dump(jmodel, params, JaxDataset(jcfg, "val",
                                                   lazy_features=True), jcfg)
        ckpt = str(tmp_path / "model.chkpt")
        save_reference_checkpoint(ckpt, model)
        path = main(_argv(fixture) + [
            "--checkpoint", ckpt, "--torch_checkpoint", "--device", "cpu",
            "--split", "val", "--val_batch_size", "3",
            "--max_n_sen", str(cfg.model.max_n_sen),
            "--output_dir", str(tmp_path / "dump")])
    assert sorted(got) == sorted(want) and len(got) == 3
    for vid, entry in want.items():
        assert sorted(got[vid]) == sorted(entry), vid
        assert "re_entity_vectors" in entry
        for key, value in entry.items():
            pairs = (zip(got[vid][key], value) if key == "entity_vectors"
                     else [(got[vid][key], value)])
            for g, w in pairs:
                assert g.dtype == np.float32 and g.shape == w.shape, key
                np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                           atol=1e-5, err_msg=f"{vid} {key}")
    assert os.path.basename(path) == "vivt_step_embedding_dict.pkl"
    with open(path, "rb") as f:
        written = pickle.load(f)
    for vid in got:
        np.testing.assert_allclose(written[vid]["entity_probs"],
                                   got[vid]["entity_probs"], atol=1e-6)


def _report(main, argv, caplog, logger):
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=logger):
        try:
            main(argv)
            code = 0
        except SystemExit as e:
            code = e.code
    return code, [r.getMessage() for r in caplog.records
                  if r.name == logger]


def test_validate_data_and_convert_features_match_svpc_tpu(fixture,
                                                           tmp_path, caplog):
    """validate_data gives svpc_tpu's report and exit code on the clean
    fixture and on a broken copy (a missing feature file, a missing
    duration row, an inverted and an out-of-range timestamp, a feature
    width off by one, a spec line that is not an object);
    convert_features writes svpc_tpu's bytes."""
    import shutil

    from svpc_torch.cli.convert_features import convert_tree
    from svpc_torch.cli.validate_data import main as validate
    from svpc_tpu.cli.convert_features import convert_tree as jax_convert
    from svpc_tpu.cli.validate_data import main as jax_validate

    cfg, _ = port_model(MODE)
    geometry = ["--video_feature_size", str(cfg.model.video_feature_size),
                "--max_n_sen", "3", "--max_t_len", "6"]
    runs = {"torch": (validate, "svpc_torch.cli.validate_data"),
            "tpu": (jax_validate, "svpc_tpu.cli.validate_data")}

    def both(argv):
        out = {k: _report(fn, argv, caplog, lg)
               for k, (fn, lg) in runs.items()}
        assert out["torch"] == out["tpu"], out
        return out["torch"]

    for split in ("train", "val"):
        code, lines = both(_argv(fixture) + geometry + ["--split", split])
        assert lines[-1].startswith("3 video(s): 0 with errors")

    broken = tmp_path / "broken"
    shutil.copytree(fixture["data_dir"], broken)
    fx = {k: (v.replace(fixture["data_dir"], str(broken))
              if isinstance(v, str) else v) for k, v in fixture.items()}
    val = os.path.join(fx["data_dir"],
                       "bosselut_split_yc2_val_anet_format.json")
    with open(val) as f:
        anns = json.load(f)
    vids = sorted(anns)
    os.remove(os.path.join(fx["video_feature_dir"], f"{vids[0]}_bn.npy"))
    anns[vids[1]]["timestamps"][0] = [5.0, 1.0]
    anns[vids[2]]["timestamps"][-1] = [1e5, 2e5]
    with open(val, "w") as f:
        json.dump(anns, f)
    with open(fx["duration_file"]) as f:
        rows = [r for r in f if not r.startswith(vids[2])]
    with open(fx["duration_file"], "w") as f:
        f.writelines(rows)
    code, lines = both(_argv(fx) + geometry + ["--split", "val"])
    assert code == 1 and sum(ln.startswith("ERROR") for ln in lines) >= 3
    wide = [g if g != str(cfg.model.video_feature_size)
            else str(cfg.model.video_feature_size + 1) for g in geometry]
    code, lines = both(_argv(fixture) + wide + ["--split", "train"])
    assert code == 1 and "feature dims" in "".join(lines)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({vids[0]: {"timestamps": [[0.0, 2.0]]},
                                "bad": [1, 2]}))
    code, lines = both(_argv(fixture) + geometry + ["--input_json",
                                                    str(spec)])
    assert code == 1 and "malformed spec line" in "".join(lines)

    assert convert_tree(fixture["video_feature_dir"],
                        str(tmp_path / "f16_port")) == \
        jax_convert(fixture["video_feature_dir"], str(tmp_path / "f16_tpu"))
    names = sorted(os.listdir(tmp_path / "f16_port"))
    assert names and names == sorted(os.listdir(tmp_path / "f16_tpu"))
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "f16_port", tmp_path / "f16_tpu", names, shallow=False)
    assert match == names and not mismatch and not errors
    assert np.load(tmp_path / "f16_port" / names[0]).dtype == np.float16

"""svpc_torch's dump_memories and feature uploads on the card, against the
CPU and against the disk-staged features.  It imports nothing but torch,
numpy, pytest and svpc_torch: the card's machine has no JAX
(tests/conftest.py imports it, hence ``--noconftest``).  The CPU tests
that hold these tools against svpc_tpu are tests/test_torch_cli_tools.py
and tests/test_torch_upload.py.

Run on the card with
``python -m pytest --noconftest -m cuda tests/test_torch_tools_card.py``."""

import base64
import io

import numpy as np
import pytest
import torch


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs this check)")


def _fixture(root, cfg):
    from svpc_torch.data.synthetic import write_training_fixture

    return write_training_fixture(str(root), cfg, n_train=2, n_val=3, seed=2,
                                  min_clips=2, max_clips=4)


@pytest.mark.cuda
def test_dump_memories_and_upload_on_the_card(tmp_path):
    """``dump_memories`` of one val batch on the card against the CPU with
    the same Gumbel noise (every array within 1e-4, the encoders and the
    full causal decoder through the kernel's float32 paths); an upload served
    on the card captions as the disk-staged video does, through the
    native packer."""
    _needs_card()
    import svpc_torch.model.svpc as svpc
    from svpc_torch.cli.dump_memories import dump_memories
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data import pipeline
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.model import SVPCModel
    from svpc_torch.ops.attention import LAUNCHES, reset_launches
    from svpc_torch.ops.gumbel import gumbel_noise, straight_through
    from svpc_torch.serving import CaptionService

    cfg = tiny_test_config("full")
    fx = _fixture(tmp_path / "data", cfg)
    cfg = cfg.replace_data(**{k: fx[k] for k in (
        "data_dir", "word2idx_path", "verb2idx_path", "duration_file",
        "video_feature_dir")}).replace_train(val_batch_size=3)
    model = SVPCModel(cfg.model, torch.Generator().manual_seed(0)).eval()
    noise = {}

    def shared(logits, tau, generator=None):
        key = tuple(logits.shape)
        if key not in noise:
            noise[key] = gumbel_noise(
                logits.shape, torch.Generator().manual_seed(1), "cpu")
        return straight_through(logits, noise[key].to(logits.device), tau)

    real, svpc.gumbel_softmax_st = svpc.gumbel_softmax_st, shared
    try:
        ds = CaptionDataset(cfg, "val", lazy_features=True)
        cpu = dump_memories(model, ds, cfg)
        reset_launches()
        card = dump_memories(model.to("cuda"), ds, cfg)
        launches = dict(LAUNCHES)
    finally:
        svpc.gumbel_softmax_st = real
    assert sorted(card) == sorted(cpu) and len(cpu) == 3
    for vid, entry in cpu.items():
        for key, value in entry.items():
            pairs = (zip(card[vid][key], value) if key == "entity_vectors"
                     else [(card[vid][key], value)])
            for got, want in pairs:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4,
                                           err_msg=f"{vid} {key}")
    # the encoders and the full causal decoder: the tile path (the step
    # encoder of a video of at most 4 steps takes the decode path)
    assert launches["fused_attention.tile.f32"] and \
        launches["fused_attention.tile.bf16"] == 0 == \
        launches["fused_attention.decode.bf16"], launches

    svc = CaptionService(cfg, model, batch_videos=2, device="cuda",
                         upload_dir=str(tmp_path / "spool"))
    with open(fx["duration_file"]) as f:
        rows = {r.split(",")[0]: r.strip().split(",")
                for r in f if r.strip()}
    vid, spec = next(iter(fx["specs"].items()))
    want = [c["sentence"] for c in svc.caption({vid: spec})[vid]]

    def b64(kind):
        buf = io.BytesIO()
        np.save(buf, np.load(f"{fx['video_feature_dir']}/{vid}_{kind}.npy"))
        return base64.b64encode(buf.getvalue()).decode()

    pipeline.reset_fills()
    entry = svc.make_entry("uploaded", dict(
        spec, duration=float(rows[vid][1]), n_frames=float(rows[vid][2]),
        features={k: b64(k) for k in ("resnet", "bn")}))
    got = svc.decode_examples([svc.example_for(entry)])[0]
    assert got == want
    assert dict(pipeline.FILLS) == {"native": 1}

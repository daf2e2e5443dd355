"""svpc_torch/parallel/pipeline.py, the port of svpc_tpu's GPipe: the
microbatch helpers and the stacked / per-layer trunk layouts against
svpc_tpu's on the same numpy inputs; the port's schedule on two gloo CPU
ranks against its own sequential trunk; ``from_jax`` of svpc_tpu's
pipeline-resident parameter tree."""

import json
import os

import numpy as np
import pytest
import torch

from tests.torch_parity import dropout_free

torch.set_num_threads(1)


def test_microbatch_helpers_and_layouts_match_svpc_tpu(caplog):
    """``auto_microbatches`` over a grid of batch rows, requests, dp and
    pp (the clamp to a divisor of the per-shard rows, the log when a
    request moves), ``split_microbatches`` / ``merge_microbatches`` with
    dp-aligned slices, and ``stack_trunk_params`` /
    ``unstack_trunk_params`` / ``has_stacked_trunks`` on a two-layer
    parameter tree: equal to svpc_tpu's."""
    import jax
    from svpc_tpu.parallel import pipeline as jpl
    from svpc_torch.parallel import pipeline as pl

    for n in (1, 6, 16, 28, 112, 144):
        for requested in (0, 1, 3, 4, 5, 8, 200):
            for dp in (1, 2, 4):
                for pp in (2, 4):
                    if n % dp:
                        continue
                    with caplog.at_level("INFO"):
                        caplog.clear()
                        got = pl.auto_microbatches(n, requested, dp, pp)
                        logged = "adjusted" in caplog.text
                    assert got == jpl.auto_microbatches(n, requested, dp,
                                                        pp), (n, requested,
                                                              dp, pp)
                    assert logged == (requested > 0 and got != requested)
    x = np.random.RandomState(0).randn(24, 3, 2).astype(np.float32)
    for n_micro, dp in ((4, 1), (3, 2), (2, 4), (6, 2)):
        want = np.asarray(jpl.split_microbatches(x, n_micro, dp))
        for arr in (x, torch.from_numpy(x)):
            got = np.asarray(pl.split_microbatches(arr, n_micro, dp))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                np.asarray(pl.merge_microbatches(
                    pl.split_microbatches(arr, n_micro, dp), dp)), x)
        np.testing.assert_array_equal(
            np.asarray(pl.merge_microbatches(want, dp)),
            np.asarray(jpl.merge_microbatches(want, dp)))

    params = dropout_free("full", layers=2)[2]["params"]
    want = jpl.stack_trunk_params(params)
    got = pl.stack_trunk_params(params)
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_leaves_with_path(t)}
    assert flat(got).keys() == flat(want).keys()
    for k, v in flat(want).items():
        np.testing.assert_array_equal(flat(got)[k], v, err_msg=k)
    assert "layers" in got["encoder"] and "layer_0" in \
        got["step_wise_encoder"]
    assert pl.has_stacked_trunks(got) and jpl.has_stacked_trunks(want)
    assert not pl.has_stacked_trunks(params)
    back = pl.unstack_trunk_params(got)
    assert flat(back).keys() == flat(params).keys()
    for k, v in flat(params).items():
        np.testing.assert_array_equal(flat(back)[k], v, err_msg=k)


def test_gpipe_matches_sequential_layers(tmp_path):
    """The clip encoder's and the decoder's trunks at 2 and 4 layers,
    --remat off and on, dropout on, pipelined over two stages (1 and 2
    layers a stage, 4 microbatches, 5 ticks): the output and every
    gradient a stage holds (its layers', the input's and, through the
    riding encoder output and the trunk-entry sum, the encoder output's)
    equal the sequential trunk's within rtol = atol = 1e-5, and every
    layer output, bubble ticks included, is finite."""
    from svpc_torch.config import tiny_test_config
    from svpc_torch.parallel.worker import run_job

    out = str(tmp_path / "gpipe")
    run_job("gpipe", dict(cfg=tiny_test_config("full").to_dict(), seed=1,
                          layers=[2, 4], device="cpu", pp=2, out=out),
            2, 60, {"OMP_NUM_THREADS": "1"})
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            cases = json.load(f)["cases"]
        assert len(cases) == 8
        for c in cases:
            assert c["tol_excess"] <= 0, (r, c)
            assert c["finite"], (r, c)
            # 5 ticks of each layer a stage holds, and the draw probe
            assert c["layer_calls"] == 5 * c["layers"] // 2 + 1, (r, c)


def test_from_jax_reads_a_pipeline_resident_tree():
    """svpc_tpu's ``stack_trunk_params`` tree (its ``--pp_size`` runs'
    layout) carries into the port as the per-layer tree does, and loads
    strictly."""
    from svpc_tpu.parallel.pipeline import stack_trunk_params
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import state_dict_from_jax

    _, _, params, cfg, _ = dropout_free("full", layers=2)
    stacked = {"params": stack_trunk_params(params["params"])}
    got = state_dict_from_jax(stacked, cfg.model)
    want = state_dict_from_jax(params, cfg.model)
    assert list(got) == list(want)
    for n, w in want.items():
        assert torch.equal(got[n], w), n
    SVPCModel(cfg.model).load_state_dict(got, strict=True)
    with pytest.raises(KeyError):
        state_dict_from_jax({"params": {"encoder": {}}}, cfg.model)

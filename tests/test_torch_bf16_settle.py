"""Training at compute_dtype="bfloat16" with bfloat16 optimizer state in
both packages, side by side from the same weights and batches
(tools/torch_bf16_train_settle.py at tiny width, one layer, the trainer's
batches of a written fixture, dropout 0, the same Gumbel noise): at every
step the port's six losses at svpc_tpu's weights of that step lie in the
band, one update of the port from svpc_tpu's state of that step lies in
the band of svpc_tpu's own bfloat16 - float32 gap (the gradients and
their norm, the updated parameters, moments and EMA shadow), and
decoding svpc_tpu's trained weights the port ends as many val
captions at once as svpc_tpu does (its decode is faithful, and the
weights decide) and writes svpc_tpu's sentence for at least 90% of the
clips (a bfloat16 greedy step may break a near tie the other way)."""

import torch

torch.set_num_threads(1)


def test_bf16_training_side_by_side(tmp_path):
    from tools.torch_bf16_train_settle import settle

    res = settle("tiny", epochs=2, steps_per_epoch=2, batch=4, init="port",
                 layers=1, pin_shape=True, n_val=4, root=str(tmp_path),
                 log=lambda line: None)
    assert res["steps"] == 4
    assert res["first_out_of_band"]["synced"] is None, [
        (r["step"], k, v) for r in res["rows"]
        for k, v in r["losses"].items() if not v["port_synced_in_band"]]
    assert res["first_out_of_band"]["update"] is None, [
        (r["step"], r["update"]) for r in res["rows"]
        if not r["update"]["in_band"]]
    empty = res["empty"]
    assert empty["port_on_svpc_tpu_weights"] == empty["svpc_tpu"], empty
    assert empty["svpc_tpu"]["of"] == empty["port"]["of"] > 0
    assert res["sentences_equal_on_svpc_tpu_weights"] >= \
        0.9 * empty["svpc_tpu"]["of"], res

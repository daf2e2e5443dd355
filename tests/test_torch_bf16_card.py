"""svpc_torch's bfloat16 model on the card against the CPU.  It imports
nothing but torch, pytest and svpc_torch: the card's machine has no JAX
(tests/conftest.py imports it, hence ``--noconftest``).  The CPU tests
that hold bfloat16 against svpc_tpu are tests/test_torch_bf16_*.py."""

import copy

import pytest
import torch


@pytest.mark.cuda
def test_bf16_model_on_the_card_matches_the_cpu():
    """The bfloat16 model on the card against the CPU on one packed batch
    (svpc_torch's own weights and batch: the card's machine has no JAX):
    probabilities and encoded state within the band of the reference side
    (twice the CPU's |bfloat16 - float32|, plus 1e-5), greedy tokens equal,
    and every deterministic attention the kernel's bfloat16 path (tile and
    decode launches, no float32 one).  The control, the card's run with the
    last decoder layer's LayerNorm gain off by 2^-4 of itself, falls
    outside the band.

    Run on the card with
    ``python -m pytest --noconftest -m cuda tests/test_torch_bf16_card.py``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs this check)")
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data.packing import pack_batch
    from svpc_torch.data.synthetic import synthetic_batch
    from svpc_torch.decode.greedy import greedy_decode
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    cfg = tiny_test_config("full")
    b = pack_batch(synthetic_batch(cfg, 3, seed=5), cfg.model.max_t_len)
    model32 = SVPCModel(cfg.model, torch.Generator().manual_seed(0))
    model16 = SVPCModel(cfg.replace_model(compute_dtype="bfloat16").model)
    model16.load_state_dict(model32.state_dict())
    control = copy.deepcopy(model16)
    w = control.get_parameter("decoder.layer.1.output.LayerNorm.weight")
    sign = torch.randint(0, 2, w.shape,
                         generator=torch.Generator().manual_seed(0)) * 2 - 1
    with torch.no_grad():
        w.mul_(1.0 + 2.0 ** -4 * sign)
    outs = {}
    with torch.no_grad():     # the re-simulator's noise differs; unread
        for name, model, dev in (("cpu32", model32, "cpu"),
                                 ("cpu16", model16, "cpu"),
                                 ("cuda16", model16, "cuda"),
                                 ("control", control, "cuda")):
            m = model.to(dev).eval()
            if name == "cuda16":
                reset_launches()
            tb = to_tensors(b, torch.device(dev), m.compute_dtype)
            outs[name] = (m(tb, deterministic=True).prediction_scores.cpu(),
                          m.encode(tb).step_vectors.cpu(),
                          greedy_decode(m, tb).cpu())
            if name == "cuda16":
                launches = dict(LAUNCHES)
    assert launches["fused_attention.tile.bf16"] > 0
    assert launches["fused_attention.decode.bf16"] > 0
    assert launches["fused_attention.tile.f32"] == \
        launches["fused_attention.decode.f32"] == 0

    def outside(card: str) -> list:
        """The outputs of run ``card`` outside the band."""
        out = []
        for i, what in enumerate(("prediction_scores", "step_vectors")):
            got, cpu16, cpu32 = (outs[k][i].float()
                                 for k in (card, "cpu16", "cpu32"))
            tol = 2.0 * float((cpu16 - cpu32).abs().max()) + 1e-5
            err = float((got - cpu16).abs().max())
            if not err <= tol:
                out.append((what, err, tol))
        return out

    assert outside("cuda16") == []
    assert outside("control") != []
    assert torch.equal(outs["cuda16"][2], outs["cpu16"][2])

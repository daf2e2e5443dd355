"""The comparisons that decide ``correct``, run after the window with the
program's state freed: the plain reference (pbench/reference) given the
same raw inputs and its own copy of the seeded weights.

Serving: for each sampled request that the window served, the reference
encodes the video from its feature files and scores every position of
the served tokens teacher-forced; the number compared is the widest gap
by which a served token's log-probability lies below the reference's best
at that position (greedy tokens are the argmax, so a sound program reads
rounding).  Training: the reference repeats the window's first three
steps with the same generator seeds, on packed batches that it builds
itself from the raw files (the videos of each batch as the program drew
them); compared
are each step's loss, each tensor's gradient norm as the optimizer got it
in step one, and each tensor's change and its EMA shadow's change after
step three, each as the gap of the norms over the larger of the tensor's
own reference norm and the median tensor's.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
from typing import Dict, List

import numpy as np
import torch

from pbench.reference import inputs as ref_inputs
from pbench.reference.model import BOS, UNK, ReferenceModel
from pbench.reference.optim import ReferenceOptimizer, step_generator
from pbench.weights import make_weights


def reference_model(c: Dict, seed: int, device) -> ReferenceModel:
    model = ReferenceModel(c).to(device)
    model.load_state_dict(make_weights(c, seed, device), strict=True)
    return model


@torch.no_grad()
def served_gap(model: ReferenceModel, c: Dict, fixture: Dict, name: str,
               tokens: np.ndarray, word2idx: Dict, device) -> float:
    """Widest log-probability gap of one served video's tokens
    (tokens (S, T) extended ids, as the program returned them)."""
    spec = fixture["specs"][name]
    ts = spec["timestamps"][:tokens.shape[0]]
    f2s = fixture["frm2sec"][name]
    ids, mask, feat = ref_inputs.video_arrays(
        fixture["video_feature_dir"], name, ts, f2s, c)
    ingr, _ = ref_inputs.ingredient_arrays(spec["ingredients"], word2idx, c)
    S, T, V = len(ts), c["max_t_len"], c["vocab_size"]
    batch = {k: torch.as_tensor(v)[None].to(device) for k, v in ingr.items()}
    batch.update(input_ids=torch.as_tensor(ids)[None].to(device),
                 input_mask=torch.as_tensor(mask)[None].to(device),
                 video_feature=torch.as_tensor(feat)[None].to(device),
                 step_mask=torch.ones(1, S, device=device))
    served = torch.as_tensor(tokens, dtype=torch.long, device=device)
    if (served[:, 0] != BOS).any():
        return math.inf
    text = torch.where(served >= V, torch.full_like(served, UNK), served)
    state = model.encode(batch)
    probs = model.score_text(batch, state, text[None],
                             torch.ones(1, S, T, device=device))[0]
    C = probs.shape[-1]
    cols = torch.arange(C, device=device)
    ext = V if c["model_mode"] == "video" else V + int(ingr["oov_count"])
    ok = (cols < ext) & (cols != UNK)
    logp = torch.log(probs[:, :T - 1].double().clamp(min=1e-300))
    best = logp.masked_fill(~ok, -math.inf).amax(-1)
    nxt = served[:, 1:]
    if ((nxt >= ext) | (nxt == UNK)).any():
        return math.inf
    got = logp.gather(-1, nxt[..., None])[..., 0]
    return float((best - got).max())


def check_serving(c: Dict, seed: int, fixture: Dict, served: List,
                  n_sample: int, device) -> Dict[str, float]:
    """``served``: (video id, tokens (S, T)) of every request the window
    finished.  The sample, drawn from the seed, holds the first of the
    longest videos and ``n_sample`` - 1 more."""
    if not served:
        return {"requests_compared": 0.0, "logprob_gap": math.inf}
    with open(fixture["word2idx_path"]) as f:
        word2idx = json.load(f)
    longest = max(range(len(served)), key=lambda i: served[i][1].shape[0])
    rng = np.random.RandomState(
        np.random.SeedSequence([seed, 4]).generate_state(1)[0])
    rest = [i for i in rng.permutation(len(served)) if i != longest]
    pick = [longest] + rest[:n_sample - 1]
    model = reference_model(c, seed, device).eval()
    gaps = [served_gap(model, c, fixture, served[i][0], served[i][1],
                       word2idx, device) for i in pick]
    return {"requests_compared": float(len(pick)),
            "tokens_compared": float(sum(served[i][1].shape[0]
                                         * (c["max_t_len"] - 1)
                                         for i in pick)),
            "logprob_gap": max(gaps)}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names) -> float:
    """Worst tensor: |program norm - reference norm| over the larger of
    the tensor's reference norm and the median tensor's."""
    med = statistics.median(ref[n] for n in ref)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def check_training(c: Dict, t: Dict, seed: int, fixture: Dict,
                   batches: List[List[str]], prog: Dict,
                   device) -> Dict[str, float]:
    """``batches``: the videos of the window's first three batches, in
    their order; ``prog``: the program's losses, step-one gradient norms,
    and changes after step three (parameters, EMA shadow), by tensor
    name."""
    from pbench.fixture import TRAIN_SPLIT_FILE
    with open(os.path.join(fixture["data_dir"], TRAIN_SPLIT_FILE)) as f:
        split = json.load(f)
    with open(fixture["word2idx_path"]) as f:
        word2idx = json.load(f)
    model = reference_model(c, seed, device).train()
    params = dict(model.named_parameters())
    p0 = {n: p.detach().clone() for n, p in params.items()}
    opt = ReferenceOptimizer(params, t)
    losses, grad = [], {}
    for k, names in enumerate(batches):
        host = ref_inputs.train_batch(fixture, split, names, t["batch_size"],
                                      word2idx, c, t["clip_multiple"],
                                      t["v_multiple"])
        batch = {key: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for key, v in host.items()}
        batch = {key: (v.long() if not v.is_floating_point() else v.float())
                 for key, v in batch.items()}
        loss = model.losses(batch, True, step_generator(device, t["seed"], k))
        loss.backward()
        losses.append(float(loss.detach()))
        opt.update({n: p.grad for n, p in params.items()})
        for p in params.values():
            p.grad = None
        if k == 0:
            grad = {n: float(opt.m[n].norm()) / (1 - t["adam_b1"])
                    for n in params}
    change = {n: float((p.detach() - p0[n]).norm())
              for n, p in params.items()}
    ema = {n: float((opt.ema[n] - p0[n]).norm()) for n in params}
    med = statistics.median(grad.values())
    moved = [n for n in params if grad[n] >= 1e-3 * med]
    for what, p, r, names in (("grad", prog["grad"], grad, list(params)),
                              ("change", prog["change"], change, moved),
                              ("ema", prog["ema"], ema, moved)):
        worst = max(names, key=lambda n: leaf_gap(p, r, [n]))
        print(f"widest {what} gap: {worst} (program {p[worst]!r}, "
              f"reference {r[worst]!r})", file=sys.stderr)
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], losses)),
        "grad_gap": leaf_gap(prog["grad"], grad, list(params)),
        "change_gap": leaf_gap(prog["change"], change, moved),
        "ema_gap": leaf_gap(prog["ema"], ema, moved),
        "tensors_compared": float(len(moved)),
    }

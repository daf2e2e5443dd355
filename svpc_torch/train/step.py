"""Train and eval steps with the reference's metric bookkeeping: the port
of svpc_tpu/train/step.py.

Metrics reproduce the reference: token accuracy over valid label positions
(train.py:32-38) and thresholded entity/action P/R counts (train.py:40-49).
Losses are sums, so gradients accumulated over microbatches equal one big
batch's.

Randomness: every dropout mask and the Gumbel noise of a train step come
from one ``torch.Generator`` seeded from ``(seed, step)`` (and the
microbatch under accumulation), as svpc_tpu folds its key by
``state.step``: a resumed run draws what an uninterrupted one would have.
The streams differ from JAX's, a seed-like difference.

``multi_train_step`` is the counterpart of svpc_tpu's
``make_multi_train_step``: one call runs K optimizer steps over a batch
stacked on the device (data/packing.py::stack_batches), each step what
``train_step`` (or, under accumulation, ``accum_train_step``) does on its
slice, and returns the metrics stacked (K,) per key.

On a mesh (``state.mesh``, parallel/mesh.py) each rank runs its dp block
of the batch: the metrics are summed over dp, the gradients are
all-reduced over dp once per optimizer step (after any accumulation),
and every draw is over the global shape (``step_generator(mesh=...)``),
so the trajectory is the one-process run's on the global batch.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from svpc_torch import tokenization as tok
from svpc_torch.config import Config
from svpc_torch.parallel.mesh import GlobalDraws
from svpc_torch.train.optim import ema_update, total_norm
from svpc_torch.train.state import TrainState


def step_generator(device, seed: int, *counters: int, mesh=None):
    """A generator on ``device`` seeded from ``seed`` and ``counters``
    (e.g. the step), mixed so that nearby pairs give unrelated streams;
    on a ``mesh`` it draws over the global shape (``GlobalDraws``)."""
    mixed = np.random.SeedSequence([seed, *counters]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(
        int(mixed) & (2 ** 63 - 1))
    return gen if mesh is None else GlobalDraws(gen, mesh)


def sum_over_dp(metrics: Dict, mesh) -> Dict:
    """Each metric summed over the dp ranks (one all-reduce, in float64;
    each value keeps its dtype)."""
    if mesh is None or mesh.dp_group is None:
        return metrics
    keys = list(metrics)
    vals = [torch.as_tensor(metrics[k]) for k in keys]
    flat = torch.stack([v.to(vals[0].device, torch.float64) for v in vals])
    dist.all_reduce(flat, group=mesh.dp_group)
    return {k: s.to(v.dtype) for k, s, v in zip(keys, flat.unbind(), vals)}


def sum_grads_over_dp(grads: Dict[str, torch.Tensor], mesh
                      ) -> Dict[str, torch.Tensor]:
    """The gradients summed over the dp ranks: one all-reduce of them laid
    end to end."""
    if mesh is None or mesh.dp_group is None:
        return grads
    names = list(grads)
    flat = torch.cat([grads[n].reshape(-1) for n in names])
    dist.all_reduce(flat, group=mesh.dp_group)
    out, off = {}, 0
    for n in names:
        k = grads[n].numel()
        out[n] = flat[off:off + k].view(grads[n].shape)
        off += k
    return out


def batch_metrics(out, batch, cfg: Config) -> Dict[str, torch.Tensor]:
    """Sum-counts for the epoch aggregator (tensors on the batch's device).
    Token accuracy is against the UNMUTATED extended labels, as the
    reference's cal_performance does even in video mode (train.py:32-38)."""
    T = cfg.model.max_t_len
    if "clip_video" in batch:
        labels = batch["clip_input_labels"][:, None, -T:]
    else:
        labels = batch["input_labels"][:, :, -T:]
    pred = out.prediction_scores.argmax(-1)
    valid = labels != tok.IGNORE
    metrics = dict(loss=out.total_loss.detach(),
                   caption_loss=out.caption_loss.detach(),
                   n_correct=((pred == labels) & valid).sum(),
                   n_word=valid.sum())
    if out.ent_probs is not None:
        sup = batch["step_mask"][..., None] * batch["entity_mask"][:, None]
        p = (out.ent_probs.detach() > 0.5) & (sup > 0)
        row = batch["step_mask"][..., None]
        pa = (out.ac_probs.detach() > 0.5) & (row > 0)
        metrics.update(
            ent_correct=(batch["alignment"] * p).sum(),
            ent_recall=(batch["alignment"] * sup).sum(),
            ent_precision=p.sum(),
            ac_correct=(batch["action"] * pa).sum(),
            ac_recall=(batch["action"] * row).sum(),
            ac_precision=pa.sum())
    return metrics


def grad_step(state: TrainState, batch, cfg: Config,
              generator: Optional[torch.Generator]) -> Dict:
    """Forward (non-deterministic) and backward of the summed loss; the
    gradients ADD into the parameters' ``.grad`` (accumulation).  The
    metrics are summed over dp."""
    out = state.model(batch, deterministic=False, generator=generator)
    out.total_loss.backward()
    return sum_over_dp(batch_metrics(out, batch, cfg), state.mesh)


def apply_step(state: TrainState, cfg: Config,
               loss: Optional[torch.Tensor] = None) -> Dict:
    """The optimizer and EMA update from the accumulated ``.grad``, which
    it then clears.  With ``skip_nonfinite_updates`` a step whose gradient
    norm (or ``loss``) is not finite keeps parameters, moments and shadow,
    and is counted; the check reads the norm on the host.  On a mesh the
    gradients are first summed over dp."""
    grads = sum_grads_over_dp(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in state.params.items()}, state.mesh)
    # the optimizer's order; tp-split tensors' norms summed over tp
    norms = state.optimizer.grad_norms(list(grads.values()))
    grad_norm = total_norm(norms)
    metrics = {"grad_norm": grad_norm}
    ok = True
    if cfg.train.skip_nonfinite_updates:
        finite = torch.isfinite(grad_norm)
        if loss is not None:
            finite = finite & torch.isfinite(loss)
        ok = bool(finite)
        metrics["nonfinite_skipped"] = int(not ok)
    if ok:
        state.optimizer.update(grads, norms)
        if state.ema_shadow is not None and cfg.train.ema_decay > 0:
            ema_update(state.ema_shadow, state.params, state.step,
                       cfg.train.ema_decay, state.optimizer.local)
    for p in state.params.values():
        p.grad = None
    state.step += 1
    return metrics


def train_step(state: TrainState, batch, cfg: Config) -> Dict:
    """One optimizer step on one batch: forward, backward, global clip,
    BertAdam, EMA; the generator is seeded from ``(seed, state.step)``."""
    device = next(iter(state.params.values())).device
    m = grad_step(state, batch, cfg,
                  step_generator(device, cfg.train.seed, state.step,
                                 mesh=state.mesh))
    m.update(apply_step(state, cfg, loss=m["loss"]))
    return m


def accum_train_step(state: TrainState, batches, cfg: Config) -> Dict:
    """ONE optimizer step over the A microbatches of ``batches`` (leading
    axis A): A ``grad_step``s, microbatch ``i`` drawing from
    ``step_generator(device, seed, state.step, i)``, then one
    ``apply_step``; the metrics summed over the microbatches.  The
    counterpart of svpc_tpu's ``make_accum_train_step``: the same draws,
    sums and guard as the loop's unfused accumulation, so a partial
    epoch-tail group (a shorter leading axis) is its partial flush."""
    device = next(iter(state.params.values())).device
    n = next(iter(batches.values())).shape[0]
    step = state.step
    ms = [grad_step(state, {k: v[i] for k, v in batches.items()}, cfg,
                    step_generator(device, cfg.train.seed, step, i,
                                   mesh=state.mesh))
          for i in range(n)]
    metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in ms]).sum(0)
               for k in ms[0]}
    metrics.update(apply_step(state, cfg))
    return metrics


def multi_train_step(state: TrainState, batches, cfg: Config) -> Dict:
    """K optimizer steps over a stacked batch (leading axis K; (K, A, ...)
    with ``grad_accum_steps`` > 1): step k runs ``train_step`` (or
    ``accum_train_step``) on slice k, exactly as K separate calls would.
    Returns each metric stacked (K,); ``aggregate_metrics`` sums them."""
    step_fn = (accum_train_step if cfg.train.grad_accum_steps > 1
               else train_step)
    k_steps = next(iter(batches.values())).shape[0]
    ms = [step_fn(state, {k: v[i] for k, v in batches.items()}, cfg)
          for i in range(k_steps)]
    return {k: torch.stack([torch.as_tensor(m[k]) for m in ms])
            for k in ms[0]}


@torch.no_grad()
def eval_step(model, batch, cfg: Config,
              generator: Optional[torch.Generator]) -> Dict:
    """Deterministic teacher-forced metrics (on the card every attention
    runs the hand-written kernel), summed over dp on a mesh;
    ``generator`` feeds the re-simulator's Gumbel noise, which eval still
    draws."""
    out = model(batch, deterministic=True, generator=generator)
    return sum_over_dp(batch_metrics(out, batch, cfg), model.mesh)


def sum_metrics(metric_list) -> Dict[str, float]:
    """Per-key sums, in list order, as Python floats; a value may be a
    stacked (K,) tensor of ``multi_train_step``, summed in float64."""
    sums: Dict[str, float] = {}
    for m in metric_list:
        for k, v in m.items():
            if isinstance(v, torch.Tensor) and v.dim():
                v = v.double().sum()
            sums[k] = sums.get(k, 0.0) + float(v)
    return sums


def aggregate_metrics(metric_list) -> Dict[str, float]:
    """Epoch-level aggregation mirroring the reference logs.  An entry may
    be an earlier ``sum_metrics`` result (a resumed epoch's first part):
    the sums then come out bit for bit as if it had not been cut."""
    sums = sum_metrics(metric_list)
    n_word = max(sums.get("n_word", 1.0), 1.0)
    out = dict(loss_per_word=sums.get("loss", 0.0) / n_word,
               acc=sums.get("n_correct", 0.0) / n_word,
               nonfinite_skipped=int(sums.get("nonfinite_skipped", 0)))

    def f1(c, r, p):
        recall = c / r if r else 0.0
        precision = c / p if p else 0.0
        if recall == 0 and precision == 0:
            return dict(recall=0.0, precision=0.0, f1=0.0)
        return dict(recall=recall, precision=precision,
                    f1=2 * recall * precision / (recall + precision))

    if "ent_correct" in sums:
        out["entity"] = f1(sums["ent_correct"], sums["ent_recall"],
                           sums["ent_precision"])
        out["action"] = f1(sums["ac_correct"], sums["ac_recall"],
                           sums["ac_precision"])
    return out

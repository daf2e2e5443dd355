"""End-to-end training loop on one device: the port of
svpc_tpu/train/loop.py.

Mirrors the reference driver (src/train.py:334-460): per-epoch training,
teacher-forced validation on the EMA weights, a greedy decode of the
validation split, checkpointing with early stopping.  Without the language
scorers (a later slice) the selection metric is the validation loss, as
svpc_tpu does under ``--no_language_eval``.  Mesh parallelism (dp, tp, pp,
ZeRO-1), multi-host runs, remat and ``steps_per_dispatch`` are later
slices: a config that asks for them (a sidecar written by svpc_tpu) raises.
The profiler, TensorBoard and language eval are later slices too.

On the card the train step's attention runs the differentiable plain
version; the hand-written attention kernel runs in validation (the
teacher-forced eval step and the greedy decode), where nothing needs a
gradient.
"""

from __future__ import annotations

import itertools
import json
import logging
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from svpc_torch.config import Config
from svpc_torch.data.packing import fixed_clip_budget, pack_examples
from svpc_torch.data.pipeline import CaptionDataset
from svpc_torch.data.prefetch import prefetch_to_device
from svpc_torch.decode.greedy import greedy_decode
from svpc_torch.decode.postprocess import (batch_to_sentences,
                                           build_submission, collect_results)
from svpc_torch.model import SVPCModel
from svpc_torch.model.svpc import to_tensors
from svpc_torch.precision import resolve_device
from svpc_torch.train.optim import GLOVE_TABLES, make_optimizer, n_parameters
from svpc_torch.train.state import TrainState, load_checkpoint, \
    save_checkpoint
from svpc_torch.train.step import (aggregate_metrics, apply_step, eval_step,
                                   grad_step, step_generator, sum_metrics,
                                   train_step)

logger = logging.getLogger(__name__)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to svpc_torch (ROADMAP.md, Queue 1)")


def check_supported(cfg: Config) -> None:
    """Raise for the svpc_tpu training options a config may carry that the
    port does not have."""
    t = cfg.train
    for flag, on in (("dp/tp/pp mesh parallelism",
                      t.dp_size * t.tp_size * t.pp_size > 1),
                     ("ZeRO-1 (--zero1)", t.zero1),
                     ("multi-host sharded data", t.multihost_sharded_data),
                     ("--steps_per_dispatch > 1", t.steps_per_dispatch > 1),
                     ("remat (--remat)", cfg.model.remat)):
        if on:
            raise _not_ported(flag)


def load_glove_into(model: SVPCModel, glove_path: str, verb_glove_path: str
                    ) -> None:
    """GloVe initialization of the word / ingredient / verb tables
    (reference train.py:691-714) from ``.npy`` or torch-saved ``.pt``
    files; a table shorter than the padded vocabulary is zero-padded."""

    def load_matrix(path):
        if path.endswith(".npy"):
            return torch.from_numpy(np.load(path).astype(np.float32))
        return torch.as_tensor(torch.load(path, weights_only=True),
                               dtype=torch.float32)

    params = dict(model.named_parameters())
    with torch.no_grad():
        for path, names in ((glove_path, GLOVE_TABLES[:2]),
                            (verb_glove_path, GLOVE_TABLES[2:])):
            if not path:
                continue
            table = load_matrix(path)
            for name in names:
                if name in params:
                    dst = params[name]
                    dst.zero_()
                    dst[:table.shape[0]] = table


def packing_builder(cfg: Config, n_clips: Optional[int] = None,
                    v_len: Optional[int] = None):
    """Batch builder for ``CaptionDataset.batches``: the packed layout
    (None when packing is off).  ``n_clips`` / ``v_len`` pin the packed
    shape (eval); left None they bucket per batch (training)."""
    if not cfg.train.pack_clips:
        return None

    def build(examples, batch_size):
        return pack_examples(
            examples, cfg.model.max_t_len, batch_size=batch_size,
            n_clips=n_clips, v_len=v_len,
            clip_multiple=cfg.train.pack_clip_multiple,
            v_multiple=cfg.train.pack_v_multiple)

    return build


def eval_packing_builder(cfg: Config, dataset, batch_size: int):
    """One packed shape across all of the dataset's eval batches."""
    return packing_builder(
        cfg, n_clips=fixed_clip_budget(dataset, batch_size,
                                       cfg.train.pack_clip_multiple),
        v_len=cfg.model.max_v_len)


def run_greedy_eval(model, dataset: CaptionDataset, cfg: Config, device,
                    max_batches: Optional[int] = None) -> dict:
    """Greedy-decode a dataset (decode/greedy.py, the KV-cached path) into
    an anet-format submission."""
    bs = cfg.train.val_batch_size
    builder = eval_packing_builder(cfg, dataset, bs)
    results = None
    for j, (batch, metas) in enumerate(dataset.batches(bs, builder=builder)):
        if max_batches and j >= max_batches:
            break
        ids = greedy_decode(model, to_tensors(batch, device))
        sentences = batch_to_sentences(ids.cpu().numpy(), metas,
                                       dataset.vocab)
        results = collect_results(sentences, metas, results)
    return build_submission(results or {})


def _open_log(path: str, header: str, resumed: bool, start_epoch: int):
    """csv log with the reference's columns (train.py:370-372); a resumed
    run keeps the rows of epochs before ``start_epoch``."""
    if resumed and os.path.exists(path):
        with open(path) as f:
            lines = f.readlines()
        kept = [ln for ln in lines[1:]
                if ln.split(",", 1)[0].isdigit()
                and int(ln.split(",", 1)[0]) < start_epoch]
        f = open(path, "w")
        f.write(lines[0] if lines else header)
        f.writelines(kept)
    else:
        f = open(path, "w")
        f.write(header)
    f.flush()
    return f


def _resume_point(resume_from: str, state: TrainState):
    """(start_epoch, host batches to skip in it, the metric sums of those
    batches) after loading a checkpoint: its ``.progress.json`` sidecar
    marks a mid-epoch save."""
    start_epoch, skip, sums = state.epoch + 1, 0, None
    prog_path = os.path.abspath(resume_from) + ".progress.json"
    if os.path.exists(prog_path):
        try:
            with open(prog_path) as f:
                prog = json.load(f)
        except (json.JSONDecodeError, OSError) as e:
            # a torn sidecar degrades to an epoch restart
            logger.warning("unreadable progress sidecar %s (%s): "
                           "restarting the epoch", prog_path, e)
            prog = {}
        if prog.get("step", state.step) != state.step:
            logger.warning("progress sidecar step %s != checkpoint step %d: "
                           "ignoring it", prog.get("step"), state.step)
        elif prog.get("batches_done", -1) >= 0:
            start_epoch, skip = int(prog["epoch"]), int(prog["batches_done"])
            sums = prog.get("metric_sums")
    return start_epoch, skip, sums


def train(cfg: Config, workdir: str,
          max_steps_per_epoch: Optional[int] = None,
          debug_nans: bool = False,
          resume_from: Optional[str] = None,
          device=None) -> Dict:
    """Train on ``device`` (the card unless ``"cpu"``).  Returns
    ``dict(history, state, model, steps)``, ``steps`` holding each
    optimizer step of this run as ``{"step", "loss", "grad_norm"}`` (the
    loss summed over an accumulation group)."""
    check_supported(cfg)
    device = resolve_device(device)
    if debug_nans:  # the reference's always-on anomaly detection
        torch.autograd.set_detect_anomaly(True)
    os.makedirs(workdir, exist_ok=True)
    cfg.to_json(os.path.join(workdir, "config.json"))

    train_ds = CaptionDataset(cfg, "train", lazy_features=True)
    val_ds = CaptionDataset(cfg, "val", lazy_features=True)
    logger.info("train videos: %d, val videos: %d", len(train_ds),
                len(val_ds))
    if len(val_ds):
        cfg = cfg.replace_train(val_batch_size=max(
            1, min(cfg.train.val_batch_size, len(val_ds))))

    model = SVPCModel(cfg.model, torch.Generator().manual_seed(
        cfg.train.seed))
    load_glove_into(model, cfg.data.glove_path, cfg.data.verb_glove_path)
    model = model.to(device)
    params = dict(model.named_parameters())
    n_frozen = (n_parameters({n: params[n] for n in GLOVE_TABLES
                              if n in params})
                if cfg.train.freeze_glove else 0)
    logger.info("Parameter Count: all %s; trainable %s",
                f"{n_parameters(params):,d}",
                f"{n_parameters(params) - n_frozen:,d}")

    steps_per_epoch = math.ceil(len(train_ds) / cfg.train.batch_size)
    # the schedule counts OPTIMIZER steps: one per accumulation group
    optimizer = make_optimizer(
        cfg.train,
        math.ceil(steps_per_epoch / max(1, cfg.train.grad_accum_steps)),
        params)
    state = TrainState.create(model, optimizer,
                              use_ema=cfg.train.ema_decay > 0,
                              ema_dtype=cfg.train.optimizer_dtype)
    start_epoch, resume_skip, resume_sums = 0, 0, None
    if resume_from:
        load_checkpoint(resume_from, state)
        start_epoch, resume_skip, resume_sums = _resume_point(resume_from,
                                                              state)
        logger.info("resumed from %s at step %d (epoch %d, skipping %d "
                    "batches)", resume_from, state.step, start_epoch,
                    resume_skip)

    resumed = bool(resume_from)
    val_builder = (eval_packing_builder(cfg, val_ds,
                                        cfg.train.val_batch_size)
                   if len(val_ds) else None)
    eval_model = SVPCModel(cfg.model).to(device).eval()

    best_score = None
    es_cnt = 0
    history = []
    hist_path = os.path.join(workdir, "history.json")
    if resumed and os.path.exists(hist_path):
        # keep the pre-resume epochs and seed the best-checkpoint
        # selection and the early-stop counter from them
        with open(hist_path) as f:
            history = [h for h in json.load(f) if h["epoch"] < start_epoch]
        for h in history:
            score = -h["val"]["loss_per_word"]
            if best_score is None or score > best_score:
                best_score, es_cnt = score, 0
            else:
                es_cnt += 1
    prog_sidecar = os.path.join(workdir, "checkpoint_last.progress.json")

    def save_last(completed_epoch: int, batches_done: int, cur_epoch: int,
                  metrics=()):
        """checkpoint_last + .progress.json; ``batches_done`` >= 0 marks a
        mid-epoch save inside ``cur_epoch`` (-1: an epoch boundary), whose
        ``metrics`` so far are kept as sums, so that a resumed epoch
        reports the same totals as an uninterrupted one."""
        state.epoch = completed_epoch
        save_checkpoint(workdir, state, cfg, name="checkpoint_last")
        with open(prog_sidecar + ".tmp", "w") as f:
            json.dump({"epoch": cur_epoch, "batches_done": batches_done,
                       "step": state.step,
                       "metric_sums": sum_metrics(metrics)}, f)
        os.replace(prog_sidecar + ".tmp", prog_sidecar)

    steps = []
    with _open_log(os.path.join(workdir, "train.log.csv"),
                   "epoch,loss,ppl,accuracy\n", resumed, start_epoch) \
            as train_log, \
            _open_log(os.path.join(workdir, "valid.log.csv"),
                      "epoch,loss,ppl,accuracy,METEOR,BLEU@4,CIDEr,re4\n",
                      resumed, start_epoch) as valid_log:
        for epoch in range(start_epoch, cfg.train.n_epoch):
            t0 = time.time()
            skip = resume_skip if epoch == start_epoch else 0
            metrics = _train_epoch(state, cfg, train_ds, epoch, skip,
                                   resume_sums if skip else None,
                                   max_steps_per_epoch, device, save_last,
                                   steps)
            train_m = (aggregate_metrics(metrics) if metrics else
                       dict(loss_per_word=float("nan"), acc=float("nan")))
            if train_m.get("nonfinite_skipped"):
                logger.warning("[epoch %d] skipped %d nonfinite update(s)",
                               epoch, train_m["nonfinite_skipped"])
            ppl = math.exp(min(train_m["loss_per_word"], 100))
            logger.info("[epoch %d] train ppl %.4f acc %.3f (%.1fs)", epoch,
                        ppl, 100 * train_m["acc"], time.time() - t0)
            train_log.write(f"{epoch},{train_m['loss_per_word']:.5f},"
                            f"{ppl:.5f},{100 * train_m['acc']:.3f}\n")

            # teacher-forced validation and the greedy decode, on the EMA
            # weights (the attention kernel's path on the card)
            eval_model.load_state_dict(state.eval_params(), strict=True)
            vmetrics = []
            for j, (batch, _) in enumerate(val_ds.batches(
                    cfg.train.val_batch_size, builder=val_builder)):
                vmetrics.append(eval_step(
                    eval_model, to_tensors(batch, device), cfg,
                    step_generator(device, epoch)))
                if max_steps_per_epoch and j + 1 >= max_steps_per_epoch:
                    break
            val_m = aggregate_metrics(vmetrics)
            if len(val_ds):
                submission = run_greedy_eval(eval_model, val_ds, cfg, device,
                                             max_batches=max_steps_per_epoch)
                with open(os.path.join(workdir, "greedy_pred_val_epoch"
                                       f"{epoch}.json"), "w") as f:
                    json.dump(submission, f, indent=2)
            vppl = math.exp(min(val_m["loss_per_word"], 100))
            valid_log.write(f"{epoch},{val_m['loss_per_word']:.5f},"
                            f"{vppl:.5f},{100 * val_m['acc']:.3f},"
                            "0.00,0.00,0.00,0.00\n")
            train_log.flush()
            valid_log.flush()
            history.append(dict(epoch=epoch, train=train_m, val=val_m,
                                lang={}))

            score = -val_m["loss_per_word"]
            save_last(epoch, -1, epoch)
            with open(hist_path, "w") as f:
                json.dump(history, f, indent=2)
            if cfg.train.save_mode == "all":
                save_checkpoint(workdir, state, cfg,
                                name=f"checkpoint_e{epoch}")
            elif best_score is None or score > best_score:
                best_score, es_cnt = score, 0
                save_checkpoint(workdir, state, cfg, name="checkpoint_best")
            else:
                es_cnt += 1
                if es_cnt > cfg.train.max_es_cnt:
                    logger.info("early stop at epoch %d (best %.4f)", epoch,
                                best_score)
                    break

    steps = [{k: float(v) if k != "step" else v for k, v in s.items()}
             for s in steps]
    return dict(history=history, state=state, model=model, steps=steps)


def _train_epoch(state: TrainState, cfg: Config, train_ds, epoch: int,
                 skip: int, resume_sums, max_steps: Optional[int], device,
                 save_last, steps) -> list:
    """One epoch's optimizer steps; returns its metric list (headed by
    ``resume_sums``, the sums of the batches a resumed epoch skips) and
    appends ``{"step", "loss", "grad_norm"}`` to ``steps`` per step.

    The shuffle is deterministic in (seed, epoch): skipping the batches a
    mid-epoch checkpoint already trained reproduces the uninterrupted
    trajectory exactly."""
    accum = max(1, cfg.train.grad_accum_steps)
    ckpt_every = cfg.train.checkpoint_every_steps
    metrics = [resume_sums] if resume_sums else []
    host_iter = train_ds.batches(
        cfg.train.batch_size, shuffle=True, seed=cfg.train.seed + epoch,
        length_group=cfg.train.length_group, builder=packing_builder(cfg),
        skip=skip)
    if max_steps:
        host_iter = itertools.islice(host_iter, max(0, max_steps - skip))
    batch_iter = prefetch_to_device(host_iter, device, size=2)
    n_micro, group_loss = 0, 0.0
    epoch_steps = skip
    try:
        for batch, _ in batch_iter:
            step_at = state.step
            if accum == 1:
                m = train_step(state, batch, cfg)
            else:
                # microbatch generators fold in (step, index)
                m = grad_step(state, batch, cfg, step_generator(
                    device, cfg.train.seed, state.step, n_micro))
                n_micro += 1
                if n_micro == accum:
                    m.update(apply_step(state, cfg))
                    n_micro = 0
            metrics.append(m)
            group_loss = group_loss + m["loss"]
            if "grad_norm" in m:
                steps.append({"step": step_at, "loss": group_loss,
                              "grad_norm": m["grad_norm"]})
                group_loss = 0.0
            epoch_steps += 1
            if ckpt_every and n_micro == 0 \
                    and epoch_steps % (ckpt_every * accum) == 0:
                # mid-epoch checkpoint every ckpt_every optimizer steps
                save_last(epoch - 1, epoch_steps, epoch, metrics)
            if max_steps and epoch_steps >= max_steps:
                break
    finally:
        batch_iter.close()  # stops the producer, also when a step raises
    if n_micro:
        # flush a partial accumulation group at the epoch's end
        step_at = state.step
        apply_m = apply_step(state, cfg)
        metrics.append(apply_m)
        steps.append({"step": step_at, "loss": group_loss,
                      "grad_norm": apply_m["grad_norm"]})
    return metrics

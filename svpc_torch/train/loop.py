"""End-to-end training loop on one device: the port of
svpc_tpu/train/loop.py.

Mirrors the reference driver (src/train.py:334-460): per-epoch training,
teacher-forced validation on the EMA weights, then language eval: a greedy
decode of the validation split scored by ``evaluation.evaluate_submission``
(METEOR, BLEU@4, CIDEr, re4 in ``valid.log.csv``).  The best checkpoint is
the one with the highest CIDEr (a CIDEr of 0 never wins), with early
stopping on it; without language eval (``eval_language=False``, or no
paragraph reference file) it is the one with the lowest validation loss.
The offline decoders of ``cli.evaluate`` / ``cli.caption``
(``make_eval_decoder``, ``run_greedy_eval``, ``run_nbest_eval``) live here
too, as in svpc_tpu.  Mesh parallelism (dp, tp, pp, ZeRO-1), multi-host
runs, remat and ``steps_per_dispatch`` are later slices: a config that asks
for them (a sidecar written by svpc_tpu) raises.  The profiler and
TensorBoard are later slices too.

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
from svpc_torch.data.anet import para_reference_files
from svpc_torch.data.packing import fixed_clip_budget, pack_examples
from svpc_torch.data.pipeline import CaptionDataset
from svpc_torch.data.prefetch import prefetch_to_device
from svpc_torch.decode.beam import beam_decode
from svpc_torch.decode.greedy import greedy_decode
from svpc_torch.decode.postprocess import (batch_to_sentences,
                                           build_submission, collect_results,
                                           nbest_entries)
from svpc_torch.evaluation import evaluate_submission
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
            v_multiple=cfg.train.pack_v_multiple,
            fill_workers=cfg.data.num_workers)

    return build


def eval_packing_builder(cfg: Config, dataset, batch_size: int):
    """One packed shape across all of the dataset's eval batches."""
    return packing_builder(
        cfg, n_clips=fixed_clip_budget(dataset, batch_size,
                                       cfg.train.pack_clip_multiple),
        v_len=cfg.model.max_v_len)


def eval_batch_size(cfg: Config, dataset_len: int) -> int:
    """The decode batch: no bigger than the dataset (a 4-video split would
    otherwise pad to the default 50)."""
    return max(1, min(cfg.train.val_batch_size, dataset_len))


def make_eval_decoder(model, cfg: Config, dataset: CaptionDataset,
                      beam_size: int = 0, n_best: int = 1) -> dict:
    """The decode function and the fixed packed shape of a dataset's eval
    batches, built once: per-epoch eval reuses them.  ``beam_size > 1``
    decodes by beam search; ``n_best > 1`` (beam only) makes it return
    ``(tokens (B, n, S, T), scores (B, n, S))`` ranked best-first."""
    bs = eval_batch_size(cfg, len(dataset))
    cfg = cfg.replace_train(val_batch_size=bs)
    if beam_size and beam_size > 1:
        decode = lambda b: beam_decode(model, b, beam_size=beam_size,
                                       n_best=n_best)
    else:
        decode = lambda b: greedy_decode(model, b)
    return dict(cfg=cfg, decode=decode,
                builder=eval_packing_builder(cfg, dataset, bs),
                device=next(model.parameters()).device,
                feature_dtype=model.compute_dtype)


def _decode_batches(dataset: CaptionDataset, decoder: dict,
                    max_batches: Optional[int] = None):
    """Yield ``(decoder output, metas)`` per eval batch in the dataset's
    order: the loop the greedy and the n-best paths share."""
    bs = decoder["cfg"].train.val_batch_size
    for j, (batch, metas) in enumerate(dataset.batches(
            bs, builder=decoder["builder"])):
        if max_batches and j >= max_batches:
            return
        yield decoder["decode"](to_tensors(batch, decoder["device"],
                                          decoder["feature_dtype"])), metas


def run_greedy_eval(model, dataset: CaptionDataset, cfg: Config,
                    max_batches: Optional[int] = None, beam_size: int = 0,
                    decoder: Optional[dict] = None) -> dict:
    """Decode a dataset on the model's device into an anet-format
    submission: greedy (the KV-cached path) by default, beam search with
    ``beam_size > 1``.  ``decoder`` from ``make_eval_decoder`` reuses one
    across calls."""
    if decoder is None:
        decoder = make_eval_decoder(model, cfg, dataset, beam_size)
    results = None
    for ids, metas in _decode_batches(dataset, decoder, max_batches):
        sentences = batch_to_sentences(ids.cpu().numpy(), metas,
                                       dataset.vocab)
        results = collect_results(sentences, metas, results)
    return build_submission(results or {})


def run_nbest_eval(model, dataset: CaptionDataset, cfg: Config,
                   beam_size: int, n_best: int,
                   max_batches: Optional[int] = None) -> dict:
    """Beam-decode a dataset keeping the ``n_best`` ranked hypotheses per
    (video, step) (the reference's ``--n_best`` surface,
    train.py:546-548): each entry carries ``nbest: [{sentence, score},
    ...]`` best-first, and its ``sentence`` is rank 0, so the dict still
    evaluates as a normal submission."""
    decoder = make_eval_decoder(model, cfg, dataset, beam_size=beam_size,
                                n_best=n_best)
    results = None
    for (tokens, scores), metas in _decode_batches(dataset, decoder,
                                                   max_batches):
        sentences, nbest = nbest_entries(tokens.cpu().numpy(),
                                         scores.cpu().numpy(), metas,
                                         dataset.vocab)
        results = collect_results(sentences, metas, results, extras=nbest)
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
          eval_language: bool = True,
          debug_nans: bool = False,
          resume_from: Optional[str] = None,
          device=None) -> Dict:
    """Train on ``device`` (the card unless ``"cpu"``).  Returns
    ``dict(best_cider, history, state, model, steps)``, ``steps`` holding
    each optimizer step of this run as ``{"step", "loss", "grad_norm"}``
    (the loss summed over an accumulation group)."""
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
        cfg = cfg.replace_train(
            val_batch_size=eval_batch_size(cfg, len(val_ds)))

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
    ref_para_path = [p for p in (
        os.path.join(cfg.data.data_dir, f)
        for f in para_reference_files(cfg.data.dset_name, "val"))
        if os.path.exists(p)]
    if eval_language and not ref_para_path:
        logger.warning("no paragraph reference files found for %s/val — "
                       "language eval disabled", cfg.data.dset_name)
        eval_language = False
    val_builder = (eval_packing_builder(cfg, val_ds,
                                        cfg.train.val_batch_size)
                   if len(val_ds) else None)
    eval_model = SVPCModel(cfg.model).to(device).eval()
    # one decoder (packed shape, batch size) for every epoch's greedy eval
    eval_decoder = (make_eval_decoder(eval_model, cfg, val_ds)
                    if eval_language and len(val_ds) else None)

    best_cider = 0.0
    best_score = 0.0 if eval_language else None  # a CIDEr of 0 never wins
    es_cnt = 0
    history = []
    hist_path = os.path.join(workdir, "history.json")
    if resumed and os.path.exists(hist_path):
        # keep the pre-resume epochs and seed the best-checkpoint
        # selection and the early-stop counter from them, so that a worse
        # epoch after the resume cannot overwrite checkpoint_best
        with open(hist_path) as f:
            history = [h for h in json.load(f) if h["epoch"] < start_epoch]
        prev = [(h["lang"].get("CIDEr", -1.0) if eval_language
                 else -h["val"]["loss_per_word"]) for h in history]
        if prev:
            # never below the fresh run's floor, e.g. when earlier epochs
            # ran without language eval
            best_score = max(0.0, max(prev)) if eval_language else max(prev)
            best_cider = max(h["lang"].get("CIDEr", 0.0) for h in history)
            # replay the early-stop counter over the earlier epochs
            running = 0.0 if eval_language else None
            for score in prev:
                if running is None or score > running:
                    running, es_cnt = score, 0
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

            # teacher-forced validation, then the greedy decode and its
            # language metrics, on the EMA weights (the attention kernel's
            # path on the card)
            eval_model.load_state_dict(state.eval_params(), strict=True)
            vmetrics = []
            for j, (batch, _) in enumerate(val_ds.batches(
                    cfg.train.val_batch_size, builder=val_builder)):
                vmetrics.append(eval_step(
                    eval_model, to_tensors(batch, device,
                                           eval_model.compute_dtype), cfg,
                    step_generator(device, epoch)))
                if max_steps_per_epoch and j + 1 >= max_steps_per_epoch:
                    break
            val_m = aggregate_metrics(vmetrics)
            lang = {}
            if eval_decoder is not None:
                submission = run_greedy_eval(eval_model, val_ds, cfg,
                                             max_batches=max_steps_per_epoch,
                                             decoder=eval_decoder)
                with open(os.path.join(workdir, "greedy_pred_val_epoch"
                                       f"{epoch}.json"), "w") as f:
                    json.dump(submission, f, indent=2)
                lang = evaluate_submission(submission, ref_para_path)
                logger.info("[epoch %d] val METEOR %.2f B4 %.2f CIDEr %.2f "
                            "re4 %.2f", epoch, 100 * lang.get("METEOR", 0),
                            100 * lang["Bleu_4"], 100 * lang["CIDEr"],
                            100 * lang["re4"])
            vppl = math.exp(min(val_m["loss_per_word"], 100))
            valid_log.write(f"{epoch},{val_m['loss_per_word']:.5f},"
                            f"{vppl:.5f},{100 * val_m['acc']:.3f},"
                            f"{100 * lang.get('METEOR', 0):.2f},"
                            f"{100 * lang.get('Bleu_4', 0):.2f},"
                            f"{100 * lang.get('CIDEr', 0):.2f},"
                            f"{100 * lang.get('re4', 0):.2f}\n")
            train_log.flush()
            valid_log.flush()
            history.append(dict(epoch=epoch, train=train_m, val=val_m,
                                lang={k: v for k, v in lang.items()
                                      if isinstance(v, (int, float))}))

            # the selection metric: CIDEr (reference train.py:428-442), else
            # the validation loss
            score = (lang.get("CIDEr", -1.0) if eval_language
                     else -val_m["loss_per_word"])
            save_last(epoch, -1, epoch)
            with open(hist_path, "w") as f:
                json.dump(history, f, indent=2)
            if cfg.train.save_mode == "all":
                # the reference's names carry the metrics (train.py:424-427)
                tag = f"checkpoint_e{epoch}"
                if lang:
                    tag += (f"_b{round(100 * lang.get('Bleu_4', 0), 2)}"
                            f"_m{round(100 * lang.get('METEOR', 0), 2)}"
                            f"_c{round(100 * lang.get('CIDEr', 0), 2)}"
                            f"_r{round(100 * lang.get('re4', 0), 2)}")
                save_checkpoint(workdir, state, cfg, name=tag)
            elif best_score is None or score > best_score:
                best_score, es_cnt = score, 0
                best_cider = lang.get("CIDEr", 0.0)
                save_checkpoint(workdir, state, cfg, name="checkpoint_best")
            else:
                es_cnt += 1
                if es_cnt > cfg.train.max_es_cnt:
                    logger.info("early stop at epoch %d (best %.4f)", epoch,
                                best_score)
                    break

    steps = [{k: float(v) if k != "step" else v for k, v in s.items()}
             for s in steps]
    return dict(best_cider=best_cider, history=history, state=state,
                model=model, steps=steps)


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
    batch_iter = prefetch_to_device(host_iter, device, size=2,
                                    feature_dtype=state.model.compute_dtype)
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

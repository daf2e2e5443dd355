"""End-to-end training loop: the port of svpc_tpu/train/loop.py.

Mirrors the reference driver (src/train.py:334-460): per-epoch training,
teacher-forced validation on the EMA weights, then language eval: a greedy
decode of the validation split scored by ``evaluation.evaluate_submission``
(METEOR, BLEU@4, CIDEr, re4 in ``valid.log.csv``).  The best checkpoint is
the one with the highest CIDEr (a CIDEr of 0 never wins), with early
stopping on it; without language eval (``eval_language=False``, or no
paragraph reference file) it is the one with the lowest validation loss.
The offline decoders of ``cli.evaluate`` / ``cli.caption``
(``make_eval_decoder``, ``run_greedy_eval``, ``run_nbest_eval``) live here
too, as in svpc_tpu.  ``steps_per_dispatch`` K > 1 groups K (x
``grad_accum_steps``) host batches into one stacked batch
(``group_stack_batches``), copied to the card in one pinned copy and run
by ``multi_train_step``.  ``tensorboard`` writes svpc_tpu's scalars
(``TBWriter``), ``profile_steps`` traces that many steady-state host
batches with ``torch.profiler`` into ``<workdir>/profile/``.

With ``dp_size * pp_size * tp_size > 1`` (one process a rank, started by
torchrun) the loop trains on the dp x pp x tp mesh of parallel/mesh.py:
every rank builds the global batch and keeps its dp block (with
``multihost_sharded_data`` it builds only its block), the model holds its
pipeline stage's trunk layers (run on the GPipe schedule of
parallel/pipeline.py, ``pp_microbatches`` a call) and its tp shards,
``zero1`` slices the moments and shadow over dp, and only rank 0 writes
logs, predictions and checkpoints (layout-free: they resume on any mesh).
The eval batch is rounded up to a multiple of dp; validation's
teacher-forced eval step pipelines as training does, while its greedy
decode runs a sequential model on the trunk gathered whole over pp (as
svpc_tpu decodes on unstacked parameters); each rank decodes its dp block
and the tokens are gathered, so every rank scores the same submission.

On the card the train step's attention runs the differentiable plain
version; the hand-written attention kernel runs in validation (the
teacher-forced eval step and the greedy decode), where nothing needs a
gradient.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import math
import os
import sys
import time
import types
from typing import Dict, Optional

import numpy as np
import torch

from svpc_torch.config import Config
from svpc_torch.data.anet import para_reference_files
from svpc_torch.data.packing import (fixed_clip_budget, pack_examples,
                                     stack_batches)
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
from svpc_torch.parallel.collectives import gather_dim
from svpc_torch.parallel.mesh import (check_stages, gather_stages,
                                      init_distributed, local_dp_shards,
                                      make_mesh, rank_device, shard_batch,
                                      without_pp, zero1_dims)
from svpc_torch.precision import resolve_device
from svpc_torch.train.optim import GLOVE_TABLES, make_optimizer
from svpc_torch.train.state import TrainState, load_checkpoint, \
    save_checkpoint
from svpc_torch.train.step import (aggregate_metrics, apply_step, eval_step,
                                   grad_step, multi_train_step,
                                   step_generator, sum_metrics, train_step)

logger = logging.getLogger(__name__)


def mesh_for(cfg: Config, device=None):
    """The dp x pp x tp mesh ``cfg.train`` asks for (None for one
    process), joining the process group torchrun set up; more processes
    than the mesh has raise."""
    t = cfg.train
    if t.dp_size * t.tp_size * t.pp_size == 1 and \
            int(os.environ.get("WORLD_SIZE", 1)) == 1:
        return None
    init_distributed(device=device)
    return make_mesh(t.dp_size, t.tp_size, t.pp_size)


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
                    v_len: Optional[int] = None, dp_shards: int = 1,
                    only_shards=None):
    """Batch builder for ``CaptionDataset.batches``: the packed layout
    (None when packing is off).  ``n_clips`` / ``v_len`` pin the packed
    shape (eval); left None they bucket per batch (training).  Each of
    ``dp_shards`` blocks packs on its own; ``only_shards`` builds only
    those blocks (``pack_examples``)."""
    if not cfg.train.pack_clips:
        return None

    def build(examples, batch_size):
        return pack_examples(
            examples, cfg.model.max_t_len, batch_size=batch_size,
            n_clips=n_clips, v_len=v_len,
            clip_multiple=cfg.train.pack_clip_multiple,
            v_multiple=cfg.train.pack_v_multiple, dp_shards=dp_shards,
            fill_workers=cfg.data.num_workers, only_shards=only_shards)

    return build


def group_stack_batches(batch_iter, k: int, max_t_len: int,
                        dp_shards: int = 1, accum: int = 1):
    """Group K (or K*accum) consecutive (batch, metas) pairs into one
    stacked batch for ``multi_train_step`` (data/packing.stack_batches).
    With ``accum > 1`` the stack is reshaped to (K, accum, ...): K
    optimizer steps of ``accum`` accumulated microbatches each.  The epoch
    tail never drops data: it yields the largest whole accumulation groups
    first, then one (1, r < accum) partial group, the unfused
    accumulation's partial flush.  Metas split at the same boundary as the
    batches, so each video is attributed to the group that carries it."""

    def emit(group, meta_groups):
        stacked = stack_batches(group, max_t_len, dp_shards)
        if accum > 1:
            stacked = {key: v.reshape((len(group) // accum, accum)
                                      + v.shape[1:])
                       for key, v in stacked.items()}
        return stacked, [m for ms in meta_groups for m in ms]

    buf, metas = [], []
    for batch, ms in batch_iter:
        buf.append(batch)
        metas.append(list(ms))
        if len(buf) == k * accum:
            yield emit(buf, metas)
            buf, metas = [], []
    if buf:
        q, r = divmod(len(buf), accum)
        if q:
            yield emit(buf[:q * accum], metas[:q * accum])
        if r:  # accum > 1 by construction (divmod(n, 1) has r == 0)
            stacked = stack_batches(buf[q * accum:], max_t_len, dp_shards)
            yield ({key: v[None] for key, v in stacked.items()},
                   [m for ms in metas[q * accum:] for m in ms])


class TBWriter:
    """Optional TensorBoard writer (the reference logs scalars with
    tensorboardX, train.py:359,387-421) on ``torch.utils.tensorboard``;
    without the ``tensorboard`` package it logs that once and the csv logs
    carry on alone."""

    def __init__(self, logdir: str, enabled: bool = True):
        self._w = None
        if enabled:
            # TensorBoard reaches for TensorFlow's file API whenever
            # TensorFlow is installed (seconds and hundreds of MB, and a
            # second XLA runtime in a process that may also run JAX); this
            # marker makes it use its own stub, which writes the same files
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                logger.info("tensorboard is not installed; csv logs only")
                return
            self._w = SummaryWriter(logdir)

    def scalar(self, tag: str, value, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def close(self):
        if self._w is not None:
            self._w.close()


class StepProfiler:
    """``profile_steps`` host batches traced with ``torch.profiler`` (CPU
    and, on the card, CUDA activities) from the first call after the
    run's first (svpc_tpu skips its compile step), into
    ``<workdir>/profile/trace.json``; an epoch that ends first writes what
    was traced (svpc_tpu/train/loop.py:654-724)."""

    def __init__(self, workdir: str, profile_steps: int, device):
        self.dir = os.path.join(workdir, "profile")
        self.want = profile_steps
        self.device = torch.device(device)
        self.prof = None
        self.seen = 0  # host batches of this run so far
        self.traced = 0
        self.done = not profile_steps

    def before_step(self) -> None:
        if self.done or self.prof is not None or self.seen < 1:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.__enter__()

    def after_step(self, n_in: int) -> None:
        self.seen += n_in
        if self.prof is None:
            return
        self.traced += n_in
        if self.traced >= self.want:
            self.finish()

    def finish(self) -> None:
        """Stop and write the trace (at the epoch's end with what it has)."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        os.makedirs(self.dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.dir, "trace.json"))
        self.prof, self.done = None, True
        logger.info("profiler trace of %d of %d requested host batches "
                    "written to %s", self.traced, self.want, self.dir)

    def close(self) -> None:
        """Stop a trace that a failed run left open, writing nothing."""
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None


def eval_packing_builder(cfg: Config, dataset, batch_size: int,
                         dp_shards: int = 1):
    """One packed shape across all of the dataset's eval batches."""
    return packing_builder(
        cfg, n_clips=fixed_clip_budget(dataset, batch_size,
                                       cfg.train.pack_clip_multiple,
                                       dp_shards),
        v_len=cfg.model.max_v_len, dp_shards=dp_shards)


def eval_batch_size(cfg: Config, dataset_len: int, mesh=None) -> int:
    """The decode batch: no bigger than the dataset (a 4-video split would
    otherwise pad to the default 50), rounded up to a multiple of the
    mesh's dp."""
    bs = max(1, min(cfg.train.val_batch_size, dataset_len))
    dp = mesh.dp_size if mesh is not None else 1
    return -(-bs // dp) * dp


def make_eval_decoder(model, cfg: Config, dataset: CaptionDataset,
                      beam_size: int = 0, n_best: int = 1) -> dict:
    """The decode function and the fixed packed shape of a dataset's eval
    batches, built once: per-epoch eval reuses them.  ``beam_size > 1``
    decodes by beam search; ``n_best > 1`` (beam only) makes it return
    ``(tokens (B, n, S, T), scores (B, n, S))`` ranked best-first.  On the
    model's mesh each rank decodes its dp block of every batch and the
    outputs are gathered."""
    mesh = getattr(model, "mesh", None)
    dp = mesh.dp_size if mesh is not None else 1
    bs = eval_batch_size(cfg, len(dataset), mesh)
    cfg = cfg.replace_train(val_batch_size=bs)
    if beam_size and beam_size > 1:
        decode = lambda b: beam_decode(model, b, beam_size=beam_size,
                                       n_best=n_best)
    else:
        decode = lambda b: greedy_decode(model, b)
    return dict(cfg=cfg, decode=decode,
                builder=eval_packing_builder(cfg, dataset, bs, dp),
                device=next(model.parameters()).device,
                feature_dtype=model.compute_dtype, mesh=mesh)


def _decode_batches(dataset: CaptionDataset, decoder: dict,
                    max_batches: Optional[int] = None):
    """Yield ``(decoder output, metas)`` per eval batch in the dataset's
    order: the loop the greedy and the n-best paths share."""
    bs, mesh = decoder["cfg"].train.val_batch_size, decoder["mesh"]
    for j, (batch, metas) in enumerate(dataset.batches(
            bs, builder=decoder["builder"])):
        if max_batches and j >= max_batches:
            return
        if mesh is not None:
            batch = shard_batch(mesh, batch)
        out = decoder["decode"](to_tensors(batch, decoder["device"],
                                           decoder["feature_dtype"]))
        if mesh is not None:  # every dp block's rows, in batch order
            out = (gather_dim(out, 0, mesh.dp_group)
                   if isinstance(out, torch.Tensor)
                   else tuple(gather_dim(t, 0, mesh.dp_group) for t in out))
        yield out, metas


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


def _open_log(path: str, header: str, resumed: bool, start_epoch: int,
              write: bool = True):
    """csv log with the reference's columns (train.py:370-372); a resumed
    run keeps the rows of epochs before ``start_epoch``.  ``write=False``
    (a rank other than 0) logs nowhere."""
    if not write:
        return open(os.devnull, "w")
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
          device=None, tensorboard: bool = True,
          profile_steps: int = 0) -> Dict:
    """Train on ``device`` (the card unless ``"cpu"``).  Returns
    ``dict(best_cider, history, state, model, steps)``, ``steps`` holding
    each optimizer step of this run as ``{"step", "loss", "grad_norm"}``
    (the loss summed over an accumulation group).  ``tensorboard`` writes
    svpc_tpu's scalars under ``workdir`` when the package is there;
    ``profile_steps`` > 0 traces that many host batches (``StepProfiler``).

    With ``cfg.train.dp_size * pp_size * tp_size > 1`` every rank calls it
    (under torchrun, or after ``init_distributed``); ``device`` is then
    each rank's (``parallel.mesh.rank_device``)."""
    check_stages(cfg.model.num_hidden_layers, cfg.train.pp_size)
    mesh = mesh_for(cfg, device)
    device = (resolve_device(device) if mesh is None
              else rank_device(device))
    main = mesh is None or mesh.is_main
    if debug_nans:  # the reference's always-on anomaly detection
        torch.autograd.set_detect_anomaly(True)
    os.makedirs(workdir, exist_ok=True)
    if main:
        cfg.to_json(os.path.join(workdir, "config.json"))

    train_ds = CaptionDataset(cfg, "train", lazy_features=True)
    val_ds = CaptionDataset(cfg, "val", lazy_features=True)
    logger.info("train videos: %d, val videos: %d", len(train_ds),
                len(val_ds))
    if len(val_ds):
        cfg = cfg.replace_train(
            val_batch_size=eval_batch_size(cfg, len(val_ds), mesh))

    # built whole from the seed (and GloVe), then cut to this rank's shards
    model = SVPCModel(cfg.model, torch.Generator().manual_seed(
        cfg.train.seed))
    load_glove_into(model, cfg.data.glove_path, cfg.data.verb_glove_path)
    pp_micro = cfg.train.pp_microbatches
    model = model.shard(mesh, pp_microbatches=pp_micro).to(device)
    params = dict(model.named_parameters())
    n_all = sum(math.prod(s) for s in model.full_shapes.values())
    n_frozen = (sum(math.prod(model.full_shapes[n]) for n in GLOVE_TABLES
                    if n in params)
                if cfg.train.freeze_glove else 0)
    logger.info("Parameter Count: all %s; trainable %s", f"{n_all:,d}",
                f"{n_all - n_frozen:,d}")

    steps_per_epoch = math.ceil(len(train_ds) / cfg.train.batch_size)
    # the schedule counts OPTIMIZER steps: one per accumulation group
    optimizer = make_optimizer(
        cfg.train,
        math.ceil(steps_per_epoch / max(1, cfg.train.grad_accum_steps)),
        params, mesh=mesh, tp_split=model.param_tp_dims,
        zero1_split=(zero1_dims(model.full_shapes, mesh)
                     if cfg.train.zero1 else None))
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
    dp = mesh.dp_size if mesh is not None else 1
    val_builder = (eval_packing_builder(cfg, val_ds,
                                        cfg.train.val_batch_size, dp)
                   if len(val_ds) else None)
    eval_model = SVPCModel(cfg.model).shard(
        mesh, pp_microbatches=pp_micro).to(device).eval()
    # one decoder (packed shape, batch size) for every epoch's greedy eval;
    # the KV-cached decode is sequential: under pp it runs a model holding
    # the whole trunk (gathered over pp), as svpc_tpu's decode_model
    decode_model, eval_decoder = eval_model, None
    if eval_language and len(val_ds):
        if mesh is not None and mesh.pp_size > 1:
            decode_model = SVPCModel(cfg.model).shard(
                without_pp(mesh)).to(device).eval()
        eval_decoder = make_eval_decoder(decode_model, cfg, val_ds)

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
        if not main:
            return
        with open(prog_sidecar + ".tmp", "w") as f:
            json.dump({"epoch": cur_epoch, "batches_done": batches_done,
                       "step": state.step,
                       "metric_sums": sum_metrics(metrics)}, f)
        os.replace(prog_sidecar + ".tmp", prog_sidecar)

    steps = []
    tb = TBWriter(workdir, tensorboard and main)
    profiler = StepProfiler(workdir, profile_steps if main else 0, device)
    with contextlib.closing(tb), contextlib.closing(profiler), \
            _open_log(os.path.join(workdir, "train.log.csv"),
                   "epoch,loss,ppl,accuracy\n", resumed, start_epoch,
                   main) as train_log, \
            _open_log(os.path.join(workdir, "valid.log.csv"),
                      "epoch,loss,ppl,accuracy,METEOR,BLEU@4,CIDEr,re4\n",
                      resumed, start_epoch, main) as valid_log:
        for epoch in range(start_epoch, cfg.train.n_epoch):
            t0 = time.time()
            skip = resume_skip if epoch == start_epoch else 0
            metrics = _train_epoch(state, cfg, train_ds, epoch, skip,
                                   resume_sums if skip else None,
                                   max_steps_per_epoch, device, save_last,
                                   steps, profiler)
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
            niter = state.step
            tb.scalar("Train/Loss", train_m["loss_per_word"], niter)
            tb.scalar("Train/Acc", train_m["acc"], niter)

            # teacher-forced validation, then the greedy decode and its
            # language metrics, on the EMA weights (the attention kernel's
            # path on the card)
            eval_params = state.eval_params()
            eval_model.load_state_dict(eval_params, strict=True)
            if decode_model is not eval_model:
                decode_model.load_state_dict(gather_stages(eval_params, mesh),
                                             strict=True)
            vmetrics = []
            for j, (batch, _) in enumerate(val_ds.batches(
                    cfg.train.val_batch_size, builder=val_builder)):
                if mesh is not None:
                    batch = shard_batch(mesh, batch)
                vmetrics.append(eval_step(
                    eval_model, to_tensors(batch, device,
                                           eval_model.compute_dtype), cfg,
                    step_generator(device, epoch, mesh=mesh)))
                if max_steps_per_epoch and j + 1 >= max_steps_per_epoch:
                    break
            val_m = aggregate_metrics(vmetrics)
            lang = {}
            if eval_decoder is not None:
                submission = run_greedy_eval(decode_model, val_ds, cfg,
                                             max_batches=max_steps_per_epoch,
                                             decoder=eval_decoder)
                if main:
                    with open(os.path.join(workdir, "greedy_pred_val_epoch"
                                           f"{epoch}.json"), "w") as f:
                        json.dump(submission, f, indent=2)
                lang = evaluate_submission(submission, ref_para_path)
                logger.info("[epoch %d] val METEOR %.2f B4 %.2f CIDEr %.2f "
                            "re4 %.2f", epoch, 100 * lang.get("METEOR", 0),
                            100 * lang["Bleu_4"], 100 * lang["CIDEr"],
                            100 * lang["re4"])
                tb.scalar("Val/METEOR", 100 * lang.get("METEOR", 0), niter)
                tb.scalar("Val/Bleu_4", 100 * lang["Bleu_4"], niter)
                tb.scalar("Val/CIDEr", 100 * lang["CIDEr"], niter)
                tb.scalar("Val/Re4", 100 * lang["re4"], niter)
            tb.scalar("Val/Loss", val_m["loss_per_word"], niter)
            tb.scalar("Val/Acc", val_m["acc"], niter)
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
            if main:
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
                 save_last, steps, profiler: StepProfiler) -> list:
    """One epoch's optimizer steps; returns its metric list (headed by
    ``resume_sums``, the sums of the batches a resumed epoch skips) and
    appends ``{"step", "loss", "grad_norm"}`` to ``steps`` per step.

    The shuffle is deterministic in (seed, epoch): skipping the batches a
    mid-epoch checkpoint already trained reproduces the uninterrupted
    trajectory exactly.  ``epoch_steps`` counts host batches: a stacked
    group of ``steps_per_dispatch`` K carries K x ``grad_accum_steps`` of
    them (the epoch's tail fewer), and the step cap applies at the source,
    before grouping, so no group overshoots it."""
    accum = max(1, cfg.train.grad_accum_steps)
    spd = cfg.train.steps_per_dispatch
    ckpt_every = cfg.train.checkpoint_every_steps
    metrics = [resume_sums] if resume_sums else []
    mesh = state.mesh
    dp = mesh.dp_size if mesh is not None else 1
    # every rank builds the global batch, or only its dp block
    only = (local_dp_shards(mesh)
            if mesh is not None and cfg.train.multihost_sharded_data
            else None)
    host_iter = train_ds.batches(
        cfg.train.batch_size, shuffle=True, seed=cfg.train.seed + epoch,
        length_group=cfg.train.length_group,
        builder=packing_builder(cfg, dp_shards=dp, only_shards=only),
        skip=skip)
    if max_steps:
        host_iter = itertools.islice(host_iter, max(0, max_steps - skip))
    if spd > 1:
        host_iter = group_stack_batches(host_iter, spd, cfg.model.max_t_len,
                                        dp_shards=dp, accum=accum)
    if mesh is not None:
        lead = 0 if spd == 1 else (2 if accum > 1 else 1)
        host_iter = ((shard_batch(mesh, b, lead), m) for b, m in host_iter)
    batch_iter = prefetch_to_device(host_iter, device, size=2,
                                    feature_dtype=state.model.compute_dtype)
    n_micro, group_loss = 0, 0.0
    epoch_steps = skip
    try:
        for batch, _ in batch_iter:
            profiler.before_step()
            step_at = state.step
            n_in = 1
            if spd > 1:
                m = multi_train_step(state, batch, cfg)
                lead = next(iter(batch.values())).shape
                n_in = lead[0] * (lead[1] if accum > 1 else 1)
                steps.extend({"step": step_at + i, "loss": m["loss"][i],
                              "grad_norm": m["grad_norm"][i]}
                             for i in range(lead[0]))
            elif accum == 1:
                m = train_step(state, batch, cfg)
            else:
                # microbatch generators fold in (step, index)
                m = grad_step(state, batch, cfg, step_generator(
                    device, cfg.train.seed, state.step, n_micro, mesh=mesh))
                n_micro += 1
                if n_micro == accum:
                    m.update(apply_step(state, cfg))
                    n_micro = 0
            metrics.append(m)
            if spd == 1:
                group_loss = group_loss + m["loss"]
                if "grad_norm" in m:
                    steps.append({"step": step_at, "loss": group_loss,
                                  "grad_norm": m["grad_norm"]})
                    group_loss = 0.0
            epoch_steps += n_in
            profiler.after_step(n_in)
            period = ckpt_every * accum
            if ckpt_every and n_micro == 0 and \
                    epoch_steps // period > (epoch_steps - n_in) // period:
                # mid-epoch checkpoint when the host batches cross a
                # multiple of ckpt_every optimizer steps
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
    profiler.finish()
    return metrics

"""Shared CLI argument handling and checkpoint loading, from
svpc_tpu/cli/common.py: the flags every CLI takes (data paths, geometry,
layout, device), the mesh flags (``--dp_size``, ``--tp_size``,
``--pp_size``; the pipeline only on ``cli.train``, the inference CLIs
refuse it with ``reject_pp``), the training flags of ``cli.train``, and
the model loader of the inference CLIs (``evaluate``, ``caption``,
``serve``, ``dump_memories``)."""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from svpc_torch.config import (MODEL_TYPE_TO_MODE, Config, DataConfig,
                               ModelConfig, TrainConfig)


def add_common_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model_type", choices=list(MODEL_TYPE_TO_MODE),
                   default="vivt",
                   help="vivt=full viv=reason_copy vi=copy v=video")
    p.add_argument("--data_dir", default="densevid_eval/yc2_data")
    p.add_argument("--video_feature_dir", required=True)
    p.add_argument("--duration_file", required=True)
    p.add_argument("--word2idx_path", default="cache/yc2_word2idx.json")
    p.add_argument("--verb2idx_path", default="cache/bosselut_verb_vocab.json")
    p.add_argument("--dset_name", default="yc2", choices=["yc2", "anet"])
    p.add_argument("--max_n_sen", type=int, default=12)
    p.add_argument("--max_t_len", type=int, default=22)
    p.add_argument("--max_v_len", type=int, default=100)
    p.add_argument("--max_i_len", type=int, default=100)
    p.add_argument("--no_pack_clips", action="store_true",
                   help="disable clip packing (compute the full padded "
                        "(B, S) step grid like the reference)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card; under "
                        "torchrun each rank takes cuda:LOCAL_RANK), "
                        "'cuda:i' (every rank on card i) or 'cpu'")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="float32: the parity path; bfloat16: activations "
                        "and most products in bfloat16, parameters, "
                        "softmaxes and losses in float32.  A run-time "
                        "choice: any checkpoint loads at either")


def add_mesh_args(p: argparse.ArgumentParser, train: bool = False) -> None:
    """The dp x pp x tp mesh (parallel/mesh.py; one process a rank,
    started by torchrun with ``--nproc_per_node dp_size * pp_size *
    tp_size``): ``--pp_size`` on every CLI as svpc_tpu's take it (the
    inference CLIs refuse values above 1, ``reject_pp``), and for
    ``cli.train`` the microbatch count, ZeRO-1 and per-rank sharded
    data."""
    p.add_argument("--dp_size", type=int, default=1)
    p.add_argument("--tp_size", type=int, default=1,
                   help="tensor-parallel axis (Megatron attention/FFN/vocab "
                        "sharding; the vocabulary tables are zero-padded to "
                        "a tp multiple)")
    p.add_argument("--pp_size", type=int, default=1,
                   help="pipeline-parallel stages (GPipe over the clip "
                        "encoder and decoder trunks, "
                        "svpc_torch/parallel/pipeline.py; cli.train only); "
                        "must divide num_hidden_layers; the same trajectory "
                        "as pp=1 up to summation order")
    if not train:
        return
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="microbatches per pipelined trunk call (0 = auto: "
                        "2 * pp_size, clamped to a divisor of the per-dp-"
                        "shard batch)")
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1: shard the Adam moments and the EMA shadow "
                        "over dp (per-rank optimizer memory / dp; numerics "
                        "unchanged: the gradients stay whole, so both norm "
                        "clips see full gradients)")
    p.add_argument("--multihost_sharded_data", action="store_true",
                   help="each rank builds only its own dp block of every "
                        "training batch (byte-equal to that block of the "
                        "global build; needs the packed layout)")


def reject_pp(args, parser) -> None:
    """Inference-side CLIs take the common --pp_size flag (shared arg
    surface) but never pipeline: decode is latency-bound KV-cached work
    where pipeline stages would only add hand-off latency.  Fail loudly
    instead of silently ignoring the flag (svpc_tpu/cli/common.py)."""
    if getattr(args, "pp_size", 1) > 1:
        parser.error("--pp_size applies to cli.train only; decode runs "
                     "the KV-cached incremental path where a pipeline "
                     "would only add stage hand-off latency (scale "
                     "inference with --dp_size/--tp_size instead)")


def config_from_args(args) -> Config:
    """Config from the data files and flags; a reference checkpoint's own
    geometry then overrides the architecture fields (cli/serve.py)."""
    with open(args.word2idx_path) as f:
        vocab_size = len(json.load(f))
    with open(args.verb2idx_path) as f:
        action_vocab_size = len(json.load(f))
    cfg = Config(
        model=ModelConfig(
            vocab_size=vocab_size, action_vocab_size=action_vocab_size,
            model_mode=MODEL_TYPE_TO_MODE[args.model_type],
            max_n_sen=args.max_n_sen, max_t_len=args.max_t_len,
            max_v_len=args.max_v_len, max_i_len=args.max_i_len,
            compute_dtype=args.compute_dtype,
            vocab_pad_multiple=max(1, getattr(args, "tp_size", 1))),
        data=DataConfig(
            dset_name=args.dset_name, data_dir=args.data_dir,
            video_feature_dir=args.video_feature_dir,
            duration_file=args.duration_file,
            word2idx_path=args.word2idx_path,
            verb2idx_path=args.verb2idx_path),
        train=TrainConfig(
            pack_clips=not args.no_pack_clips,
            dp_size=getattr(args, "dp_size", 1),
            tp_size=getattr(args, "tp_size", 1),
            zero1=getattr(args, "zero1", False),
            multihost_sharded_data=getattr(args, "multihost_sharded_data",
                                           False),
            pp_size=getattr(args, "pp_size", 1),
            pp_microbatches=getattr(args, "pp_microbatches", 0)),
    )
    cfg.model.validate()
    return cfg


def add_train_args(p: argparse.ArgumentParser) -> None:
    """Architecture, loss and optimization flags (reference
    train.py:471-562; the defaults are the experiment of record)."""
    p.add_argument("--glove_path", default="")
    p.add_argument("--verb_glove_path", default="")
    for name, default in (("hidden_size", 768), ("intermediate_size", 768),
                          ("lstm_hidden_size", 768), ("num_hidden_layers", 2),
                          ("num_attention_heads", 12), ("word_vec_size", 300),
                          ("video_feature_size", 3072),
                          ("type_vocab_size", 4)):
        p.add_argument(f"--{name}", type=int, default=default)
    for name, default in (("hidden_dropout_prob", 0.1),
                          ("attention_probs_dropout_prob", 0.1),
                          ("layer_norm_eps", 1e-12),
                          ("initializer_range", 0.02),
                          ("temperature", 0.5), ("lam", 0.5),
                          ("label_smoothing", 0.1)):
        p.add_argument(f"--{name}", type=float, default=default)
    p.add_argument("--share_wd_cls_weight", action="store_true",
                   help="tie the LM head to the word embedding (requires "
                        "word_vec_size == hidden_size)")
    p.add_argument("--use_asl", default="asl", choices=["asl", "bce"],
                   help="action-supervision loss (reference train.py:512)")
    p.add_argument("--grad_clip", type=float, default=1.0,
                   help="global grad-norm clip; -1 disables")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_warmup_proportion", type=float, default=0.1)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--val_batch_size", type=int, default=50)
    p.add_argument("--n_epoch", type=int, default=50)
    p.add_argument("--max_es_cnt", type=int, default=10,
                   help="early-stop patience (reference train.py:541)")
    p.add_argument("--save_mode", choices=["all", "best"], default="best")
    p.add_argument("--seed", type=int, default=2019)
    p.add_argument("--ema_decay", type=float, default=0.9999)
    p.add_argument("--freeze_glove", action="store_true",
                   help="do not train the GloVe-initialized tables")
    p.add_argument("--optimizer_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="storage dtype of the Adam moments and EMA shadow "
                        "(the math stays float32)")
    p.add_argument("--grad_accum_steps", type=int, default=1,
                   help="host batches per optimizer step (exact under the "
                        "summed losses)")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize encoder/decoder layers on the "
                        "backward pass (torch.utils.checkpoint): ~num_layers "
                        "x less activation memory for one extra layer "
                        "forward; values unchanged")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="optimizer steps per call: K > 1 stacks K batches "
                        "into one pinned copy and runs K steps over it - "
                        "same trajectory on the same stacked batches; "
                        "composes with --grad_accum_steps (each step then "
                        "accumulates that many microbatch gradients)")
    p.add_argument("--length_group", type=int, default=0,
                   help="sort windows of K*batch_size shuffled videos by "
                        "clip length before batching; 0 = uniform shuffle")
    p.add_argument("--checkpoint_every_steps", type=int, default=0,
                   help="also save checkpoint_last every N optimizer steps "
                        "(mid-epoch resume; 0 = per epoch)")
    p.add_argument("--num_workers", type=int, default=0,
                   help="threads for the native feature fill (the fill "
                        "releases the GIL; the reference's flag is the "
                        "triple-dashed '---num_workers', train.py:554)")
    p.add_argument("--debug", action="store_true",
                   help="one step per epoch")


def train_config_from_args(args) -> Config:
    """``config_from_args`` plus the flags of ``add_train_args``."""
    cfg = config_from_args(args)
    cfg = cfg.replace_model(
        hidden_size=args.hidden_size,
        intermediate_size=args.intermediate_size,
        lstm_hidden_size=args.lstm_hidden_size,
        num_hidden_layers=args.num_hidden_layers,
        num_attention_heads=args.num_attention_heads,
        word_vec_size=args.word_vec_size,
        video_feature_size=args.video_feature_size,
        type_vocab_size=args.type_vocab_size,
        hidden_dropout_prob=args.hidden_dropout_prob,
        attention_probs_dropout_prob=args.attention_probs_dropout_prob,
        layer_norm_eps=args.layer_norm_eps,
        initializer_range=args.initializer_range,
        temperature=args.temperature, lambda_=args.lam,
        label_smoothing=args.label_smoothing,
        share_wd_cls_weight=args.share_wd_cls_weight,
        use_asl=args.use_asl == "asl", remat=args.remat)
    cfg = cfg.replace_data(glove_path=args.glove_path,
                           verb_glove_path=args.verb_glove_path,
                           num_workers=args.num_workers)
    cfg = cfg.replace_train(
        batch_size=args.batch_size, val_batch_size=args.val_batch_size,
        n_epoch=args.n_epoch, max_es_cnt=args.max_es_cnt,
        save_mode=args.save_mode, seed=args.seed, lr=args.lr,
        grad_clip=args.grad_clip,
        lr_warmup_proportion=args.lr_warmup_proportion,
        ema_decay=args.ema_decay, freeze_glove=args.freeze_glove,
        optimizer_dtype=args.optimizer_dtype,
        grad_accum_steps=args.grad_accum_steps,
        steps_per_dispatch=args.steps_per_dispatch,
        length_group=args.length_group,
        checkpoint_every_steps=args.checkpoint_every_steps,
        debug=args.debug)
    cfg.model.validate()
    return cfg


def adopt_checkpoint_sidecar(cfg: Config, checkpoint_path: str) -> Config:
    """Adopt what a trainer checkpoint's weights fix from its
    ``<checkpoint>.cfg.json`` sidecar: the whole model configuration (the
    inference CLIs take no architecture flags), keeping the caller's clip
    budget ``max_n_sen`` and ``compute_dtype``, a run-time choice as in
    svpc_tpu (whose sidecar adoption never takes it).  The caller's model
    type and vocabularies must be the checkpoint's.  No sidecar: ``cfg`` as
    it is."""
    sidecar = os.path.abspath(checkpoint_path) + ".cfg.json"
    if not os.path.exists(sidecar):
        return cfg
    saved = Config.from_json(sidecar)
    for field in ("model_mode", "vocab_size", "action_vocab_size"):
        want, got = getattr(saved.model, field), getattr(cfg.model, field)
        if want != got:
            raise SystemExit(f"{checkpoint_path} was trained with "
                             f"{field}={want}, the flags give {got}")
    return Config(
        model=dataclasses.replace(saved.model, max_n_sen=cfg.model.max_n_sen,
                                  compute_dtype=cfg.model.compute_dtype),
        data=cfg.data, train=cfg.train)


def load_reference_model(cfg: Config, checkpoint: str):
    """(cfg, model) from a reference-format ``.chkpt``: the checkpoint's
    geometry overrides the architecture fields of ``cfg``; the serving
    budgets (steps, entities, OOV slots) and the compute dtype stay the
    caller's."""
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.from_jax import load_reference_checkpoint
    m = cfg.model
    mcfg, state = load_reference_checkpoint(
        checkpoint, max_n_sen=m.max_n_sen, max_entities=m.max_entities,
        max_oov=m.max_oov, max_ingr_words=m.max_ingr_words,
        compute_dtype=m.compute_dtype)
    model = SVPCModel(mcfg)
    model.load_state_dict(state, strict=True)
    return Config(model=mcfg, data=cfg.data, train=cfg.train), model


def load_checkpoint_model(cfg: Config, args):
    """(cfg, model on the CPU, in eval mode) for the inference CLIs.

    ``--torch_checkpoint``: a reference-format ``.chkpt``.  Otherwise a
    checkpoint of the port's trainer (train/state.py): its sidecar's
    configuration, and the EMA weights as eval weights.  svpc_tpu's orbax
    checkpoints (directories) need JAX and are refused."""
    from svpc_torch.model import SVPCModel
    from svpc_torch.train.state import load_eval_weights

    path = args.checkpoint
    if not os.path.exists(path) and not os.path.exists(path + ".swp"):
        raise SystemExit(f"checkpoint not found: {path}")
    if getattr(args, "torch_checkpoint", False):
        cfg, model = load_reference_model(cfg, path)
        return cfg, model.eval()
    if os.path.isdir(path):
        raise SystemExit(
            f"{path} is an orbax checkpoint directory: svpc_torch reads "
            "its own trainer's checkpoints and reference-format .chkpt "
            "files (pass --torch_checkpoint); orbax checkpoints need JAX, "
            "convert them with svpc_tpu's cli.export_checkpoint")
    cfg = adopt_checkpoint_sidecar(cfg, path)
    model = SVPCModel(cfg.model)
    model.load_state_dict(load_eval_weights(path), strict=True)
    return cfg, model.eval()


def load_eval_model(cfg: Config, args, make_ds):
    """(cfg, model, dataset) for the offline tools: the checkpoint as
    ``load_checkpoint_model`` loads it, then ``make_ds(cfg)`` on the
    adopted configuration; ``val_batch_size`` is capped at the dataset's
    size."""
    cfg, model = load_checkpoint_model(cfg, args)
    ds = make_ds(cfg)
    if len(ds) == 0:
        missing = getattr(ds, "missing", [])
        detail = (f" ({len(missing)} video(s) dropped for missing feature "
                  f"files, e.g. {', '.join(missing[:5])})" if missing else "")
        raise SystemExit(f"dataset is empty{detail}")
    if len(ds) < cfg.train.val_batch_size:
        cfg = cfg.replace_train(val_batch_size=len(ds))
    return cfg, model, ds

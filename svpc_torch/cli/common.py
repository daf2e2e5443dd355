"""Shared CLI argument handling, from svpc_tpu/cli/common.py: the flags
every CLI takes (data paths, geometry, layout, device) and the training
flags of ``cli.train``, for what the port's trainer supports."""

from __future__ import annotations

import argparse
import json

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
                   help="'cuda' (default; raises without a card) or 'cpu'")


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
            max_v_len=args.max_v_len, max_i_len=args.max_i_len),
        data=DataConfig(
            dset_name=args.dset_name, data_dir=args.data_dir,
            video_feature_dir=args.video_feature_dir,
            duration_file=args.duration_file,
            word2idx_path=args.word2idx_path,
            verb2idx_path=args.verb2idx_path),
        train=TrainConfig(pack_clips=not args.no_pack_clips),
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
    p.add_argument("--length_group", type=int, default=0,
                   help="sort windows of K*batch_size shuffled videos by "
                        "clip length before batching; 0 = uniform shuffle")
    p.add_argument("--checkpoint_every_steps", type=int, default=0,
                   help="also save checkpoint_last every N optimizer steps "
                        "(mid-epoch resume; 0 = per epoch)")
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
        use_asl=args.use_asl == "asl")
    cfg = cfg.replace_data(glove_path=args.glove_path,
                           verb_glove_path=args.verb_glove_path)
    cfg = cfg.replace_train(
        batch_size=args.batch_size, val_batch_size=args.val_batch_size,
        n_epoch=args.n_epoch, max_es_cnt=args.max_es_cnt,
        save_mode=args.save_mode, seed=args.seed, lr=args.lr,
        grad_clip=args.grad_clip,
        lr_warmup_proportion=args.lr_warmup_proportion,
        ema_decay=args.ema_decay, freeze_glove=args.freeze_glove,
        optimizer_dtype=args.optimizer_dtype,
        grad_accum_steps=args.grad_accum_steps,
        length_group=args.length_group,
        checkpoint_every_steps=args.checkpoint_every_steps,
        debug=args.debug)
    cfg.model.validate()
    return cfg

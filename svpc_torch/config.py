"""Single-source-of-truth configuration for svpc_torch (the port's own
copy of svpc_tpu/config.py; field names and defaults are identical so
config sidecars written by either package load in the other).

The reference spreads configuration over three near-duplicate argparse
blocks (src/train.py:463-608, src/test.py:125-269, src/dump_memories.py:77-221)
plus an EasyDict (src/train.py:657-686).  Here one frozen dataclass is shared
by every CLI and serialized inside checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict

# Model ablation modes (reference: src/train.py:614-621, scripts/train.sh:26-44)
#   "full"        == vivt : video + ingredients + visual simulator + textual re-simulator
#   "reason_copy" == viv  : video + ingredients + visual simulator
#   "copy"        == vi   : video + ingredients (pointer-generator copy)
#   "video"       == v    : video only
MODEL_MODES = ("full", "reason_copy", "copy", "video")
MODEL_TYPE_TO_MODE = {"vivt": "full", "viv": "reason_copy", "vi": "copy", "v": "video"}
MODE_TO_MODEL_TYPE = {v: k for k, v in MODEL_TYPE_TO_MODE.items()}


@dataclass(frozen=True)
class ModelConfig:
    """Model hyper-parameters.

    Defaults are the reference's experiment-of-record values
    (src/train.py:471-562 + scripts/train.sh:19-21).
    """

    # transformer core
    hidden_size: int = 768
    intermediate_size: int = 768
    lstm_hidden_size: int = 768
    num_hidden_layers: int = 2
    num_attention_heads: int = 12
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    # the reasoner's action-selector dropout — the reference hardcodes
    # p=0.4 (model.py:757); configurable so parity tests can zero it
    reasoner_dropout_prob: float = 0.4
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02

    # vocabulary / embeddings
    vocab_size: int = 951          # cache/yc2_word2idx.json
    word_vec_size: int = 300       # GloVe
    action_vocab_size: int = 384   # cache/bosselut_verb_vocab.json
    type_vocab_size: int = 4       # PAD / CLS / SEP / VID (model.py:834)
    share_wd_cls_weight: bool = False
    # round vocab-sized parameters (word-embedding tables, LM head) up to
    # a multiple of this so they divide the tensor-parallel mesh axis
    # (V=951 is odd — without padding every vocab-dim sharding rule would
    # silently fall back to replication at tp=2).  Semantics-neutral: the
    # padded logit columns are sliced off inside LMPredictionHead and the
    # padded table rows are never indexed; 1 (default) keeps parameter
    # shapes byte-identical to the reference for checkpoint interop.
    vocab_pad_multiple: int = 1

    # video features
    video_feature_size: int = 3072  # 2048 ResNet + 1024 BN-Inception flow

    # sequence geometry (scripts/train.sh:19-21)
    max_v_len: int = 100
    max_t_len: int = 22
    max_n_sen: int = 12            # training step cap; eval datasets use +10
    max_i_len: int = 100           # ingredient token budget

    # fixed-shape padding (replaces the reference's ragged python
    # slicing; measured over the whole YC2 corpus: max entities = 31,
    # max per-example OOV = 9, max steps in any split = 16)
    max_entities: int = 32
    max_oov: int = 16
    max_ingr_words: int = 8        # max tokens in one ingredient phrase

    # ablation / simulator
    model_mode: str = "full"
    temperature: float = 0.5       # gumbel-softmax tau
    lambda_: float = 0.5           # re-simulation loss weight
    label_smoothing: float = 0.1
    use_asl: bool = True           # asymmetric loss for actions (else BCE
                                   # sum — the reference advertises this
                                   # ablation but hardcodes ASL)

    # numerics: "float32" reproduces the reference token-for-token;
    # "bfloat16" is the fast path (matmuls in bf16, softmax/LN in f32;
    # svpc_torch/precision.py)
    compute_dtype: str = "float32"
    # kept so config sidecars round-trip with svpc_tpu.  The port ignores
    # it: on a CUDA tensor every deterministic attention runs the
    # hand-written kernel (svpc_torch/ops/attention.py) whatever its value
    use_pallas: bool = False
    # recompute each encoder / decoder layer on the backward pass
    # (torch.utils.checkpoint, model/layers.py); a training knob, values
    # unchanged
    remat: bool = False

    @property
    def max_position_embeddings(self) -> int:
        return self.max_v_len + self.max_t_len

    @property
    def max_seq_len(self) -> int:
        return self.max_v_len + self.max_t_len

    @property
    def extended_vocab_size(self) -> int:
        return self.vocab_size + self.max_oov

    @property
    def padded_vocab_size(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def validate(self) -> None:
        if self.hidden_size % self.num_attention_heads != 0:
            raise ValueError(
                f"hidden_size {self.hidden_size} not divisible by "
                f"num_attention_heads {self.num_attention_heads}")
        if self.model_mode not in MODEL_MODES:
            raise ValueError(f"model_mode must be one of {MODEL_MODES}")
        if self.vocab_pad_multiple < 1:
            raise ValueError("vocab_pad_multiple must be >= 1")
        if self.share_wd_cls_weight and self.word_vec_size != self.hidden_size:
            raise ValueError(
                "word_vec_size must equal hidden_size when sharing the word "
                "embedding with the classifier weight")


@dataclass(frozen=True)
class DataConfig:
    """Host data-pipeline configuration."""

    dset_name: str = "yc2"
    data_dir: str = "densevid_eval/yc2_data"
    video_feature_dir: str = ""
    duration_file: str = ""
    word2idx_path: str = "cache/yc2_word2idx.json"
    verb2idx_path: str = "cache/bosselut_verb_vocab.json"
    glove_path: str = ""            # optional .npy / .pt GloVe matrix
    verb_glove_path: str = ""
    num_workers: int = 0
    sampling_sec: float = 0.5       # recursive_caption_dataset.py:118


@dataclass(frozen=True)
class TrainConfig:
    """Optimization / loop configuration (reference defaults of record).

    The trainer (train/loop.py) reads the optimization, schedule, EMA,
    checkpoint and layout fields, and ``steps_per_dispatch`` (K optimizer
    steps per call over one stacked copy, train/step.py).  The
    parallelism fields (``dp_size``, ``tp_size``, ``pp_size``,
    ``pp_microbatches``, ``zero1``, ``multihost_sharded_data``),
    ``donate_state`` and ``rng_impl`` are svpc_tpu's, kept so config
    sidecars round-trip; the trainer raises for the ones it cannot
    honour."""

    lr: float = 1e-4
    lr_warmup_proportion: float = 0.1
    lr_schedule: str = "warmup_linear"
    grad_clip: float = 1.0          # global clip in the train loop (train.py:141-142)
    ema_decay: float = 0.9999
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-6
    n_epoch: int = 50
    max_es_cnt: int = 10            # early-stop patience on CIDEr
    batch_size: int = 16
    val_batch_size: int = 50
    seed: int = 2019
    freeze_glove: bool = False
    save_mode: str = "best"         # "best" | "all"
    debug: bool = False
    grad_accum_steps: int = 1
    skip_nonfinite_updates: bool = True
    optimizer_dtype: str = "float32"
    dp_size: int = 1
    tp_size: int = 1
    zero1: bool = False
    multihost_sharded_data: bool = False
    pp_size: int = 1
    pp_microbatches: int = 0
    donate_state: bool = True
    # clip packing (data/packing.py): compute only the real clips of a
    # batch instead of the padded (B, S) grid, with video-span bucketing;
    # the same results as the dense layout (tests/test_torch_decode.py)
    pack_clips: bool = True
    pack_clip_multiple: int = 16    # packed-clip-count bucket granularity
    pack_v_multiple: int = 16       # video-span bucket granularity
    rng_impl: str = "rbg"           # "rbg" | "threefry2x32"
    steps_per_dispatch: int = 1
    checkpoint_every_steps: int = 0
    length_group: int = 0

    def __post_init__(self):
        if self.steps_per_dispatch < 1:
            raise ValueError("steps_per_dispatch must be >= 1")
        if self.pp_size < 1:
            raise ValueError("pp_size must be >= 1")
        if self.multihost_sharded_data and not self.pack_clips:
            raise ValueError(
                "--multihost_sharded_data requires the packed layout "
                "(it builds per-dp-shard packed blocks); drop "
                "--no_pack_clips")


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        return cls(
            model=_filtered(ModelConfig, d.get("model", {})),
            data=_filtered(DataConfig, d.get("data", {})),
            train=_filtered(TrainConfig, d.get("train", {})),
        )

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def replace_model(self, **kw) -> "Config":
        return dataclasses.replace(self, model=dataclasses.replace(self.model, **kw))

    def replace_train(self, **kw) -> "Config":
        return dataclasses.replace(self, train=dataclasses.replace(self.train, **kw))

    def replace_data(self, **kw) -> "Config":
        return dataclasses.replace(self, data=dataclasses.replace(self.data, **kw))


def _filtered(cls, d: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def tiny_test_config(model_mode: str = "full") -> Config:
    """A miniature config for fast unit tests (CPU-runnable)."""
    return Config(
        model=ModelConfig(
            hidden_size=32, intermediate_size=32, lstm_hidden_size=32,
            num_hidden_layers=2, num_attention_heads=4,
            vocab_size=64, word_vec_size=16, action_vocab_size=24,
            video_feature_size=24, max_v_len=10, max_t_len=8,
            max_n_sen=4, max_i_len=20, max_entities=6, max_oov=4,
            max_ingr_words=4, model_mode=model_mode,
        ),
        train=TrainConfig(batch_size=2, val_batch_size=2, n_epoch=1),
    )

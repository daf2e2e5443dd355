"""Carry weights into the port: from JAX params, and from (or to) reference
PyTorch ``.chkpt`` files.

``build_mapping`` is the port's own copy of
svpc_tpu/model/import_torch.py:build_mapping (JAX parameter path ->
reference state-dict name, "T" where a flax ``(in, out)`` kernel transposes
to a torch ``(out, in)`` weight).  The port's module tree uses exactly the
reference names, so a mapped state dict loads with ``strict=True``; on a
tp mesh ``SVPCModel.load_full_state_dict`` keeps each rank's shards of it
(svpc_tpu's ``shard_params`` after the import).
"""

from __future__ import annotations

import sys
import types
from typing import Dict, Tuple

import numpy as np
import torch

from svpc_torch.config import ModelConfig
from svpc_torch.model.embeddings import sinusoid_table

Mapping = Dict[str, Tuple[str, str]]


def _wordfc(prefix_t: str, prefix_f: str) -> Mapping:
    """Sequential(LN, Dropout, Linear, ReLU, LN) -> ln_in/dense/ln_out."""
    return {
        f"{prefix_f}/ln_in/ln/scale": (f"{prefix_t}.0.weight", None),
        f"{prefix_f}/ln_in/ln/bias": (f"{prefix_t}.0.bias", None),
        f"{prefix_f}/dense/kernel": (f"{prefix_t}.2.weight", "T"),
        f"{prefix_f}/dense/bias": (f"{prefix_t}.2.bias", None),
        f"{prefix_f}/ln_out/ln/scale": (f"{prefix_t}.4.weight", None),
        f"{prefix_f}/ln_out/ln/bias": (f"{prefix_t}.4.bias", None),
    }


def _dense(prefix_t: str, prefix_f: str) -> Mapping:
    return {f"{prefix_f}/kernel": (f"{prefix_t}.weight", "T"),
            f"{prefix_f}/bias": (f"{prefix_t}.bias", None)}


def _ln(prefix_t: str, prefix_f: str) -> Mapping:
    return {f"{prefix_f}/ln/scale": (f"{prefix_t}.weight", None),
            f"{prefix_f}/ln/bias": (f"{prefix_t}.bias", None)}


def _attention(prefix_t: str, prefix_f: str) -> Mapping:
    out: Mapping = {}
    for name in ("query", "key", "value"):
        out.update(_dense(f"{prefix_t}.{name}", f"{prefix_f}/{name}"))
    return out


def _encoder(prefix_t: str, prefix_f: str, n_layers: int) -> Mapping:
    out: Mapping = {}
    for i in range(n_layers):
        t, f = f"{prefix_t}.layer.{i}", f"{prefix_f}/layer_{i}"
        out.update(_attention(f"{t}.attention.self", f"{f}/attention/self"))
        out.update(_dense(f"{t}.attention.output.dense",
                          f"{f}/attention/output/dense"))
        out.update(_ln(f"{t}.attention.output.LayerNorm",
                       f"{f}/attention/output/layer_norm"))
        out.update(_dense(f"{t}.hidden_intermediate.dense",
                          f"{f}/intermediate/dense"))
        out.update(_dense(f"{t}.output.dense", f"{f}/output/dense"))
        out.update(_ln(f"{t}.output.LayerNorm", f"{f}/output/layer_norm"))
    return out


def _decoder(prefix_t: str, prefix_f: str, n_layers: int) -> Mapping:
    out: Mapping = {}
    for i in range(n_layers):
        t, f = f"{prefix_t}.layer.{i}", f"{prefix_f}/layer_{i}"
        out.update(_attention(f"{t}.self_attention", f"{f}/self_attention"))
        out.update(_attention(f"{t}.dec_enc_attention",
                              f"{f}/dec_enc_attention"))
        out.update(_ln(f"{t}.norm1", f"{f}/norm1"))
        out.update(_ln(f"{t}.norm2", f"{f}/norm2"))
        out.update(_dense(f"{t}.output.dense", f"{f}/output/dense"))
        out.update(_ln(f"{t}.output.LayerNorm", f"{f}/output/layer_norm"))
    return out


def _reasoner(prefix_t: str, prefix_f: str) -> Mapping:
    out: Mapping = {f"{prefix_f}/action_embeddings":
                    (f"{prefix_t}.action_embeddings", None)}
    for f, t in (("action_selector_0", "action_selector.0"),
                 ("action_selector_1", "action_selector.3"),
                 ("W1", "W1.0"), ("W2", "W2"), ("W3", "W3"), ("W4", "W4")):
        out.update(_dense(f"{prefix_t}.{t}", f"{prefix_f}/{f}"))
    return out


def _lstm(prefix_t: str, prefix_f: str) -> Mapping:
    out: Mapping = {}
    for f_dir, t_sfx in (("fwd", "l0"), ("bwd", "l0_reverse")):
        for f_name, t_name in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                               ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            out[f"{prefix_f}/{f_name}_{f_dir}"] = (
                f"{prefix_t}.{t_name}_{t_sfx}", None)
    return out


def build_mapping(model_mode: str, n_layers: int) -> Mapping:
    m: Mapping = {
        "text_embeddings/word_embeddings/embedding":
            ("text_embeddings.word_embeddings.weight", None),
        "token_type_embeddings/embedding": ("token_type_embeddings.weight",
                                            None),
    }
    m.update(_wordfc("text_embeddings.word_fc", "text_embeddings/word_fc"))
    m.update(_wordfc("video_embeddings.video_embeddings", "video_embeddings"))
    m.update(_encoder("encoder", "encoder", n_layers))
    m.update(_encoder("step_wise_encoder", "step_wise_encoder", n_layers))
    m.update(_decoder("decoder", "decoder", n_layers))
    m.update(_dense("decoder_classifier.transform.dense",
                    "decoder_classifier/transform/dense"))
    m.update(_ln("decoder_classifier.transform.LayerNorm",
                 "decoder_classifier/transform/layer_norm"))
    m["decoder_classifier/decoder/kernel"] = (
        "decoder_classifier.decoder.weight", "T")
    m["decoder_classifier/bias"] = ("decoder_classifier.bias", None)
    if model_mode != "video":
        m["ingredient_embeddings/word_embeddings/embedding"] = (
            "ingredient_embeddings.word_embeddings.weight", None)
        m.update(_wordfc("ingredient_embeddings.word_fc",
                         "ingredient_embeddings/word_fc"))
        m.update(_dense("Wing", "pointer_generator/wing"))
        m.update(_dense("pgen_linear.0", "pointer_generator/pgen"))
    if model_mode in ("full", "reason_copy"):
        m.update(_reasoner("reasoner", "reasoner"))
        m.update(_dense("Wac.0", "Wac"))
        m.update(_dense("Went.0", "Went"))
    if model_mode == "full":
        m.update(_reasoner("recipe_reasoner", "recipe_reasoner"))
        m.update(_lstm("recipe_encoder", "recipe_encoder"))
    return m


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _plain(tree):
    """Nested mappings (flax's FrozenDict included) as plain dicts."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def state_dict_from_jax(params, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX params (a nested dict of numpy arrays, with or without the
    top-level ``"params"`` key) -> the port's state dict (CPU float32).
    A pipeline-resident tree of svpc_tpu's ``--pp_size`` runs (its trunks'
    layers stacked in ``layers`` subtrees) is unstacked first, with the
    port's copy of ``unstack_trunk_params``."""
    from svpc_torch.parallel.pipeline import (has_stacked_trunks,
                                              unstack_trunk_params)
    tree = _plain(params["params"] if "params" in params else params)
    if has_stacked_trunks(tree):
        tree = unstack_trunk_params(tree)
    flat = _flatten(tree)
    out: Dict[str, torch.Tensor] = {}
    for f_key, (t_key, transform) in build_mapping(
            cfg.model_mode, cfg.num_hidden_layers).items():
        if f_key not in flat:
            raise KeyError(f"JAX param {f_key} not found")
        val = np.asarray(flat[f_key], np.float32)
        out[t_key] = torch.tensor(val.T if transform == "T" else val)
    return out


# ---------------------------------------------------------------------- #
# reference-format .chkpt files
# ---------------------------------------------------------------------- #

_PE_BUFFERS = ("ingredient_embeddings.position_embeddings_ingr.pe",
               "video_embeddings.position_embeddings_video.pe",
               "text_embeddings.position_embeddings_text.pe")
_STEP_PE = "step_positional_encoding.pe"


def _is_reference_extra(name: str) -> bool:
    """Reference state-dict entries the port does not hold: the sinusoidal
    PE buffers and the dead MART ``memory_intermediate`` layers
    (svpc_tpu/model/import_torch.py:261-277)."""
    return (name in _PE_BUFFERS or name == _STEP_PE
            or ".memory_intermediate." in name)


def _ensure_easydict() -> None:
    """The reference pickles an easydict.EasyDict config; provide the class
    when the package is absent."""
    if "easydict" in sys.modules:
        return
    try:
        import easydict  # noqa: F401
        return
    except ImportError:
        pass
    mod = types.ModuleType("easydict")

    class EasyDict(dict):
        def __getattr__(self, k):
            try:
                return self[k]
            except KeyError as e:
                raise AttributeError(k) from e

        def __setattr__(self, k, v):
            self[k] = v

    mod.EasyDict = EasyDict
    sys.modules["easydict"] = mod


def model_config_from_reference(ref_cfg: dict, **overrides) -> ModelConfig:
    """Map the reference rt_config (train.py:657-686) onto ModelConfig."""
    kw = dict(
        hidden_size=ref_cfg["hidden_size"],
        intermediate_size=ref_cfg["intermediate_size"],
        lstm_hidden_size=ref_cfg.get("lstm_hidden_size",
                                     ref_cfg["hidden_size"]),
        num_hidden_layers=ref_cfg["num_hidden_layers"],
        num_attention_heads=ref_cfg["num_attention_heads"],
        hidden_dropout_prob=ref_cfg["hidden_dropout_prob"],
        attention_probs_dropout_prob=ref_cfg["attention_probs_dropout_prob"],
        layer_norm_eps=ref_cfg["layer_norm_eps"],
        vocab_size=ref_cfg["vocab_size"],
        word_vec_size=ref_cfg["word_vec_size"],
        action_vocab_size=ref_cfg["action_vocab_size"],
        video_feature_size=ref_cfg["video_feature_size"],
        max_v_len=ref_cfg["max_v_len"],
        max_t_len=ref_cfg["max_t_len"],
        max_i_len=ref_cfg.get("max_i_len", 100),
        model_mode=ref_cfg["model_mode"],
        temperature=ref_cfg.get("temperature", 0.5),
        lambda_=ref_cfg.get("lambda_", 0.5),
        label_smoothing=ref_cfg.get("label_smoothing", 0.1),
        share_wd_cls_weight=ref_cfg.get("share_wd_cls_weight", False),
        compute_dtype="float32",
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def load_reference_checkpoint(path: str, **overrides
                              ) -> Tuple[ModelConfig, Dict[str, torch.Tensor]]:
    """(ModelConfig, state dict) from a reference-format ``.chkpt``
    (``{"model", "model_cfg", "opt", "epoch"}``, reference
    train.py:401-405).  Drops exactly the reference extras the port does
    not hold; the rest must load with ``strict=True``.  ``overrides`` set
    ModelConfig fields the checkpoint does not carry (e.g. max_n_sen)."""
    _ensure_easydict()
    # the file is a pickle written by the reference or by save_reference_
    # checkpoint; its config is an EasyDict, so weights_only cannot be used
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    cfg = model_config_from_reference(dict(ckpt["model_cfg"]), **overrides)
    state = {}
    for k, v in ckpt["model"].items():
        if _is_reference_extra(k):
            continue
        if k.endswith(".action_embeddings.weight"):  # nn.Embedding form
            k = k[:-len(".weight")]
        state[k] = v.detach().float()
    return cfg, state


def save_reference_checkpoint(path: str, model, epoch: int = 0) -> None:
    """torch.save ``model`` as a reference-format ``.chkpt`` (the port's
    counterpart of svpc_tpu/model/import_torch.py:export_reference_
    checkpoint): the reference state dict, its PE buffers and zeroed
    ``memory_intermediate`` layers, and the reference config keys."""
    m: ModelConfig = model.cfg
    state = {k: v.detach().cpu().clone() for k, v in
             model.state_dict().items()}
    pe = torch.from_numpy(sinusoid_table(m.max_position_embeddings,
                                         m.hidden_size))
    for name in _PE_BUFFERS:
        state[name] = pe.clone()
    state[_STEP_PE] = torch.from_numpy(sinusoid_table(50, m.hidden_size))
    for enc in ("encoder", "step_wise_encoder"):
        for i in range(m.num_hidden_layers):
            p = f"{enc}.layer.{i}.memory_intermediate.dense"
            state[p + ".weight"] = torch.zeros(m.intermediate_size,
                                               m.hidden_size)
            state[p + ".bias"] = torch.zeros(m.intermediate_size)
    model_cfg = {k: getattr(m, k) for k in (
        "hidden_size", "intermediate_size", "lstm_hidden_size",
        "num_hidden_layers", "num_attention_heads", "hidden_dropout_prob",
        "attention_probs_dropout_prob", "layer_norm_eps", "vocab_size",
        "word_vec_size", "action_vocab_size", "video_feature_size",
        "max_v_len", "max_t_len", "max_i_len", "model_mode", "temperature",
        "lambda_", "label_smoothing", "share_wd_cls_weight",
        "max_position_embeddings")}
    torch.save({"model": state, "model_cfg": model_cfg, "opt": None,
                "epoch": epoch}, path)

"""Training state and checkpoints: the port of svpc_tpu/train/state.py.

A checkpoint is one ``torch.save`` of the model's reference-named state
dict, the optimizer moments and step, the EMA shadow, the global step and
the last finished epoch, so training resumes exactly (the reference saves
weights only, train.py:401-405).  A ``<name>.cfg.json`` sidecar carries the
config.

On a mesh every tensor of a checkpoint is whole: ``state_dict`` gathers
the parameters over tp and pp and the moments and shadow over dp
(ZeRO-1), tp and pp on every rank, rank 0 writes it, and
``load_state_dict`` keeps this rank's stage and slices, so a checkpoint
of one layout resumes on another (pp2 <-> pp1 included).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from svpc_torch.config import Config
from svpc_torch.parallel.collectives import gather_dim
from svpc_torch.train.optim import BertAdam


class TrainState:
    """The model (its parameters train in place), the optimizer, the EMA
    shadow (None disables EMA), the global step (``niter``) and the last
    finished epoch."""

    def __init__(self, model, optimizer: BertAdam,
                 ema_shadow: Optional[Dict[str, torch.Tensor]],
                 step: int = 0, epoch: int = 0):
        self.model = model
        self.optimizer = optimizer
        self.ema_shadow = ema_shadow
        self.step = step
        self.epoch = epoch

    @classmethod
    def create(cls, model, optimizer: BertAdam, use_ema: bool,
               ema_dtype: Optional[str] = None) -> "TrainState":
        """``ema_dtype="bfloat16"`` stores the shadow rounded
        (TrainConfig.optimizer_dtype); blending stays float32.  Under
        ZeRO-1 the shadow holds this rank's slices (``BertAdam.local``)."""
        dt = torch.bfloat16 if ema_dtype == "bfloat16" else None
        shadow = ({n: optimizer.local(n, p).detach().to(dt or p.dtype,
                                                        copy=True)
                   for n, p in optimizer.params.items()}
                  if use_ema else None)
        return cls(model, optimizer, shadow)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.optimizer.params

    @property
    def mesh(self):
        return self.optimizer.mesh

    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The weights evaluation uses: the EMA shadow when enabled (the
        reference evaluates the EMA-assigned model, train.py:393-395),
        widened back to the parameters' dtype; this rank's tp shards
        (ZeRO-1 slices are gathered over dp: every rank calls it)."""
        if self.ema_shadow is None:
            return {n: p.detach() for n, p in self.params.items()}
        opt = self.optimizer
        return {n: (gather_dim(s, opt.zero1_split[n], self.mesh.dp_group)
                    if n in opt.zero1_split else s).to(self.params[n].dtype)
                for n, s in self.ema_shadow.items()}

    def state_dict(self) -> dict:
        """Everything whole (every rank of a mesh calls it)."""
        shadow = self.ema_shadow
        if shadow is not None:
            shadow = self.optimizer.whole_all(shadow)
        return {"model": self.model.full_state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema_shadow": shadow,
                "step": self.step, "epoch": self.epoch}

    def load_state_dict(self, payload: dict) -> None:
        """From a checkpoint of any layout: each rank keeps its slices."""
        self.model.load_full_state_dict(payload["model"])
        self.optimizer.load_state_dict(payload["optimizer"])
        if (payload["ema_shadow"] is None) != (self.ema_shadow is None):
            raise ValueError("checkpoint and state disagree on EMA "
                             "(TrainConfig.ema_decay)")
        if self.ema_shadow is not None:
            with torch.no_grad():
                for n, t in self.ema_shadow.items():
                    t.copy_(self.optimizer.from_whole(
                        n, payload["ema_shadow"][n]))
        self.step = int(payload["step"])
        self.epoch = int(payload["epoch"])


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg: Config,
                    name: str = "checkpoint") -> str:
    """Write ``<ckpt_dir>/<name>`` beside the old one as ``<name>.swp`` and
    rename it over, so that a crash mid-save leaves the previous
    checkpoint (or the complete .swp) in place.  On a mesh every rank
    calls it (the tensors are gathered) and rank 0 writes."""
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    tmp = path + ".swp"
    payload = state.state_dict()
    if state.mesh is not None and not state.mesh.is_main:
        return path
    torch.save(payload, tmp)
    os.replace(tmp, path)
    cfg.to_json(path + ".cfg.json")
    return path


def _existing(path: str) -> str:
    """``path``, or ``<path>.swp`` when a crash left only the
    replacement."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".swp"):
        path = path + ".swp"
    return path


def load_eval_weights(path: str) -> Dict[str, torch.Tensor]:
    """The weights evaluation uses, from a checkpoint, on the CPU: its
    model state dict with the EMA shadow (widened back to each parameter's
    dtype) in place of the parameters when the run kept one, as
    ``TrainState.eval_params`` gives them."""
    payload = torch.load(_existing(path), map_location="cpu",
                         weights_only=True)
    weights = dict(payload["model"])
    if payload["ema_shadow"] is not None:
        weights.update({n: s.to(weights[n].dtype)
                        for n, s in payload["ema_shadow"].items()})
    return weights


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore ``state`` in place from a checkpoint (its tensors land on the
    state's device); falls back to ``<path>.swp`` when a crash left only
    the replacement."""
    device = next(iter(state.params.values())).device
    state.load_state_dict(torch.load(_existing(path), map_location=device,
                                     weights_only=True))
    return state

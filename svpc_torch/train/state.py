"""Training state and checkpoints: the port of svpc_tpu/train/state.py.

A checkpoint is one ``torch.save`` of the model's reference-named state
dict, the optimizer moments and step, the EMA shadow, the global step and
the last finished epoch, so training resumes exactly (the reference saves
weights only, train.py:401-405).  A ``<name>.cfg.json`` sidecar carries the
config.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from svpc_torch.config import Config
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
        (TrainConfig.optimizer_dtype); blending stays float32."""
        dt = torch.bfloat16 if ema_dtype == "bfloat16" else None
        shadow = ({n: p.detach().to(dt or p.dtype, copy=True)
                   for n, p in optimizer.params.items()}
                  if use_ema else None)
        return cls(model, optimizer, shadow)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self.optimizer.params

    def eval_params(self) -> Dict[str, torch.Tensor]:
        """The weights evaluation uses: the EMA shadow when enabled (the
        reference evaluates the EMA-assigned model, train.py:393-395),
        widened back to the parameters' dtype."""
        if self.ema_shadow is None:
            return {n: p.detach() for n, p in self.params.items()}
        return {n: s.to(self.params[n].dtype)
                for n, s in self.ema_shadow.items()}

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "ema_shadow": self.ema_shadow,
                "step": self.step, "epoch": self.epoch}

    def load_state_dict(self, payload: dict) -> None:
        self.model.load_state_dict(payload["model"], strict=True)
        self.optimizer.load_state_dict(payload["optimizer"])
        if (payload["ema_shadow"] is None) != (self.ema_shadow is None):
            raise ValueError("checkpoint and state disagree on EMA "
                             "(TrainConfig.ema_decay)")
        if self.ema_shadow is not None:
            with torch.no_grad():
                for n, t in self.ema_shadow.items():
                    t.copy_(payload["ema_shadow"][n])
        self.step = int(payload["step"])
        self.epoch = int(payload["epoch"])


def save_checkpoint(ckpt_dir: str, state: TrainState, cfg: Config,
                    name: str = "checkpoint") -> str:
    """Write ``<ckpt_dir>/<name>`` beside the old one as ``<name>.swp`` and
    rename it over, so that a crash mid-save leaves the previous
    checkpoint (or the complete .swp) in place."""
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    tmp = path + ".swp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, path)
    cfg.to_json(path + ".cfg.json")
    return path


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Restore ``state`` in place from a checkpoint (its tensors land on the
    state's device); falls back to ``<path>.swp`` when a crash left only
    the replacement."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".swp"):
        path = path + ".swp"
    device = next(iter(state.params.values())).device
    state.load_state_dict(torch.load(path, map_location=device,
                                     weights_only=True))
    return state

"""Optimization: BertAdam with the reference's global clip, and EMA.

The port of svpc_tpu/train/optim.py (reference src/rtransformer/
optimization.py):
  * BertAdam (:219-338): Adam with NO bias correction, per-parameter
    gradient-norm clipping (1.0) inside the step, decoupled weight decay
    added to the update, the schedule's multiplier applied per step;
  * the LR schedules (:35-180): warmup_linear / warmup_constant /
    warmup_cosine / constant;
  * EMA (:183-216): a shadow copy blended with the warmup-aware decay
    ``min(decay, (1+step)/(10+step))``;
  * the reference train loop's *global* grad-norm clip (train.py:141-142),
    applied before the step.

Parameters are addressed by the port's state-dict names, which are the
reference PyTorch names, so the reference decay grouping (train.py:339-343)
applies to them directly.  Schedule and EMA scalars are computed in
float32 on the host, as the JAX package computes them in float32.

On a mesh (parallel/mesh.py) the parameters are this rank's tp shards
and the gradients are whole over dp (the step all-reduces them): both
clips read each tensor's full norm, its local norm's square summed over
tp where it is tp-split.  With ZeRO-1 each rank keeps the moments (and
the EMA shadow) of its dp slice of each tensor only, updates that slice
and all-gathers the updated slices over dp.  On a pp mesh a rank holds
its stage's trunk layers only, with their moments and shadow: the
per-parameter clip reads each tensor's own norm, and the global clip's
total gathers every stage's trunk norms over pp and sums the squares in
the whole model's order (a replicated tensor counted once).
``state_dict`` gathers the moments whole (over dp, tp and pp) and
``load_state_dict`` keeps this rank's slices, so a checkpoint holds no
layout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from svpc_torch.config import TrainConfig
from svpc_torch.parallel.collectives import all_gather_list, gather_dim
from svpc_torch.parallel.mesh import (dp_slice, gather_stages, tp_slice,
                                      trunk_layer)

# the GloVe-initialized tables (word / ingredient / verb embeddings);
# ``freeze_glove`` keeps them fixed, the reference's
# from_pretrained(freeze=True) (train.py:694-714)
GLOVE_TABLES = ("text_embeddings.word_embeddings.weight",
                "ingredient_embeddings.word_embeddings.weight",
                "reasoner.action_embeddings",
                "recipe_reasoner.action_embeddings")

_F32 = np.float32


def lr_schedule_fn(schedule: Optional[str], warmup: float,
                   t_total: int) -> Callable[[int], np.float32]:
    """Multiplier as a function of the optimizer step (reference
    optimization.py:53-180), in float32."""
    warmup = max(warmup, 0.0)
    if warmup >= 1.0:
        # warmup_linear's (warmup - 1) denominator would be 0; the
        # reference validates 0 <= warmup < 1 the same way
        raise ValueError(f"warmup proportion must be in [0, 1), got {warmup}")
    if schedule not in (None, "none", "constant", "warmup_constant",
                        "warmup_linear", "warmup_cosine"):
        raise ValueError(f"unknown schedule {schedule}")
    w = _F32(warmup)

    def mult(step: int) -> np.float32:
        if t_total < 0 or schedule in (None, "none", "constant"):
            return _F32(1.0)
        progress = _F32(step) / _F32(t_total)
        if progress < w:
            return progress / w
        if schedule == "warmup_constant":
            return _F32(1.0)
        # (warmup - 1) and (1 - warmup) are rounded once, from doubles
        if schedule == "warmup_linear":
            return max((progress - _F32(1.0)) / _F32(warmup - 1.0),
                       _F32(0.0))
        after = (progress - w) / _F32(1.0 - warmup)
        return _F32(0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * after))

    return mult


def decays(name: str) -> bool:
    """The reference grouping: no weight decay iff the parameter's name
    contains 'bias' or 'LayerNorm.weight'.  So the WordFC layer norms
    (``word_fc.0.weight``) and the decoder's ``norm1`` / ``norm2`` weights
    ARE decayed, and the LSTM's ``bias_ih_l0`` is not."""
    return "bias" not in name and "LayerNorm.weight" not in name


def grad_norms(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each gradient's L2 norm (one multi-tensor launch on the card)."""
    return list(torch._foreach_norm(grads))


def total_norm(norms: List[torch.Tensor]) -> torch.Tensor:
    """The global norm: the norm of the per-parameter norms, their squares
    summed in order as svpc_tpu's clip_by_global_norm_torch sums them (a
    tree reduction rounds differently, and that can move a bfloat16 moment
    by a unit)."""
    return torch.sqrt(sum(torch._foreach_mul(norms, norms)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-6))``, the reference's clip factor."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_by_global_norm_torch(grads: List[torch.Tensor],
                              max_norm: float) -> List[torch.Tensor]:
    """torch.nn.utils.clip_grad_norm_ as the reference loop calls it
    (train.py:141-142): scale every gradient by ``min(1, max_norm /
    (total + 1e-6))``, the total being the norm of the per-parameter
    norms."""
    return torch._foreach_mul(
        grads, clip_scale(total_norm(grad_norms(grads)), max_norm))


class BertAdam:
    """The reference BertAdam over named parameters, preceded by the global
    clip (``global_clip`` > 0).  Moments are stored in ``state_dtype``
    ("bfloat16" halves their memory traffic); their math runs in float32.
    ``frozen`` names get no update (their moments still advance, as the
    JAX chain zeroes updates after the step).

    ``mesh`` with ``tp_split`` (name -> the dim a parameter is split on
    over tp, None when replicated) and ``zero1_split`` (name -> the dim of
    its dp slice under ZeRO-1, None when held whole) lays the optimizer
    out as the module docstring says."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 schedule: Optional[str] = "warmup_linear",
                 warmup: float = 0.1, t_total: int = -1, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0,
                 global_clip: float = 0.0,
                 state_dtype: Optional[str] = None,
                 frozen: Iterable[str] = (), mesh=None,
                 tp_split: Optional[Dict[str, Optional[int]]] = None,
                 zero1_split: Optional[Dict[str, Optional[int]]] = None):
        self.params = params
        self.mesh = mesh
        self.tp_split = {n: d for n, d in (tp_split or {}).items()
                         if d is not None and mesh is not None
                         and mesh.tp_size > 1}
        # this rank's tensors only (a pp stage holds some trunk layers)
        self.zero1_split = {n: d for n, d in (zero1_split or {}).items()
                            if d is not None and mesh is not None
                            and n in params}
        # the stage-resident trunk tensors on a pp mesh
        self.staged = ([n for n in params if trunk_layer(n) is not None]
                       if mesh is not None and mesh.pp_size > 1 else [])
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.global_clip = global_clip
        self.schedule = lr_schedule_fn(schedule, warmup, t_total)
        self.frozen = frozenset(frozen)
        sdt = torch.bfloat16 if state_dtype == "bfloat16" else None
        self.m = {n: torch.zeros_like(self.local(n, p), dtype=sdt or p.dtype)
                  for n, p in params.items()}
        self.v = {n: torch.zeros_like(self.local(n, p), dtype=sdt or p.dtype)
                  for n, p in params.items()}
        self.step = 0

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's ZeRO-1 slice of a tp-local tensor (a view; the
        tensor itself without ZeRO-1)."""
        return dp_slice(t, self.zero1_split.get(name), self.mesh)

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A moment- or shadow-shaped slice gathered to the parameter's
        full tensor: over dp (ZeRO-1), then over tp; every rank calls it."""
        if name in self.zero1_split:
            t = gather_dim(t, self.zero1_split[name], self.mesh.dp_group)
        if name in self.tp_split:
            t = gather_dim(t, self.tp_split[name], self.mesh.tp_group)
        return t

    def from_whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a full tensor (``whole``'s inverse)."""
        return self.local(name, tp_slice(t, self.tp_split.get(name),
                                         self.mesh))

    def grad_norms(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each gradient's full L2 norm (``grads`` in ``self.params``
        order): a tp-split tensor's local squared norm summed over tp."""
        norms = grad_norms(grads)
        split = [i for i, n in enumerate(self.params) if n in self.tp_split]
        if split:
            sq = torch.stack([norms[i] for i in split]) ** 2
            dist.all_reduce(sq, group=self.mesh.tp_group)
            for i, s in zip(split, sq.sqrt().unbind()):
                norms[i] = s
        return norms

    def total_norm(self, norms: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grad_norms``: on a pp mesh every stage's
        trunk norms are gathered over pp and the squares summed in the
        whole model's order (each trunk's layers stage by stage), so it
        is the pp=1 total."""
        if not self.staged:
            return total_norm(norms)
        names = list(self.params)
        at = {n: i for i, n in enumerate(names)}
        parts = all_gather_list(torch.stack([norms[at[n]]
                                             for n in self.staged]),
                                self.mesh.pp_group)
        whole, done = [], set()
        for i, n in enumerate(names):
            hit = trunk_layer(n)
            if hit is None:
                whole.append(norms[i])
            elif hit[0] not in done:
                done.add(hit[0])
                pos = [j for j, m in enumerate(self.staged)
                       if trunk_layer(m)[0] == hit[0]]
                for part in parts:
                    whole.extend(part[pos].unbind())
        return total_norm(whole)

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor],
               norms: Optional[List[torch.Tensor]] = None) -> None:
        """One step from ``grads`` (name -> tensor): parameters, moments
        and the step count change in place.  ``norms`` are the gradients'
        ``grad_norms`` in ``self.params`` order, when the caller has them
        (the global clip's total is their norm)."""
        names = list(self.params)
        gs = [grads[n] for n in names]
        if self.global_clip > 0:
            if norms is None:
                norms = self.grad_norms(gs)
            gs = torch._foreach_mul(
                gs, clip_scale(self.total_norm(norms), self.global_clip))
            # the per-parameter clip reads the clipped gradients' own norms,
            # as the reference does: norms * scale rounds differently, and
            # that moves bfloat16 moments by a unit
            norms = None
        if self.max_grad_norm > 0:
            if norms is None:
                norms = self.grad_norms(gs)
            gs = torch._foreach_mul(gs, list(clip_scale(
                torch.stack(norms), self.max_grad_norm).unbind()))
        lr_t = float(_F32(self.lr) * self.schedule(self.step))
        b1, b2 = self.b1, self.b2
        for name, g in zip(names, gs):
            g = self.local(name, g)
            m = b1 * self.m[name].float() + (1 - b1) * g
            v = b2 * self.v[name].float() + (1 - b2) * g * g
            self.m[name].copy_(m)
            self.v[name].copy_(v)
            if name in self.frozen:
                continue
            p = self.local(name, self.params[name])
            u = m / (v.sqrt() + self.eps)
            if self.weight_decay > 0 and decays(name):
                u = u + self.weight_decay * p
            p.add_(-lr_t * u)
        if self.zero1_split:
            self._gather_slices()
        self.step += 1

    def _gather_slices(self) -> None:
        """Every dp rank's updated ZeRO-1 slices into every rank's
        parameters: one all-gather of the slices laid end to end."""
        mesh = self.mesh
        names = list(self.zero1_split)
        mine = torch.cat([self.local(n, self.params[n]).reshape(-1)
                          for n in names])
        parts = [torch.empty_like(mine) for _ in range(mesh.dp_size)]
        dist.all_gather(parts, mine, group=mesh.dp_group)
        for r, flat in enumerate(parts):
            off = 0
            for n in names:
                view = dp_slice(self.params[n], self.zero1_split[n],
                                dataclasses.replace(mesh, dp_index=r))
                view.copy_(flat[off:off + view.numel()].view(view.shape))
                off += view.numel()

    def state_dict(self) -> dict:
        """Step and moments, the moments whole (every rank calls it)."""
        return {"step": self.step,
                "m": self.whole_all(self.m), "v": self.whole_all(self.v)}

    def whole_all(self, tensors: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """Moment- or shadow-shaped slices gathered whole: each over dp
        and tp (``whole``), then every stage's over pp."""
        return gather_stages({n: self.whole(n, t) for n, t in
                              tensors.items()}, self.mesh)

    def load_state_dict(self, state: dict) -> None:
        """From whole moments (a checkpoint of any layout): this rank's
        stage and slices."""
        self.step = int(state["step"])
        for key in ("m", "v"):
            for n, t in getattr(self, key).items():
                t.copy_(self.from_whole(n, state[key][n]))


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int,
                   params: Dict[str, torch.Tensor], mesh=None,
                   tp_split: Optional[Dict[str, Optional[int]]] = None,
                   zero1_split: Optional[Dict[str, Optional[int]]] = None
                   ) -> BertAdam:
    """The global clip then BertAdam, over ``steps_per_epoch * n_epoch``
    scheduled steps (svpc_tpu/train/optim.py:make_optimizer); ``mesh``,
    ``tp_split`` and ``zero1_split`` as ``BertAdam`` takes them."""
    return BertAdam(
        params, lr=cfg.lr, schedule=cfg.lr_schedule,
        warmup=cfg.lr_warmup_proportion,
        t_total=steps_per_epoch * cfg.n_epoch, b1=cfg.adam_b1,
        b2=cfg.adam_b2, eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
        global_clip=cfg.grad_clip, state_dtype=cfg.optimizer_dtype,
        frozen=GLOVE_TABLES if cfg.freeze_glove else (), mesh=mesh,
        tp_split=tp_split, zero1_split=zero1_split)


@torch.no_grad()
def ema_update(shadow: Dict[str, torch.Tensor],
               params: Dict[str, torch.Tensor], step: int,
               decay: float, local=None) -> None:
    """shadow <- (1-d)*param + d*shadow, d = min(decay, (1+step)/(10+step))
    (reference optimization.py:196-203; ``step`` is the global iteration).
    A bf16 shadow blends in float32 and stores rounded.  ``local(name,
    param)`` gives the slice a ZeRO-1 shadow holds (``BertAdam.local``)."""
    s = _F32(step)
    d = min(_F32(decay), (_F32(1.0) + s) / (_F32(10.0) + s))
    keep, take = float(d), float(_F32(1.0) - d)
    for name, sh in shadow.items():
        p = params[name] if local is None else local(name, params[name])
        sh.copy_(take * p + keep * sh.float())


"""The plain reference of one training step's optimizer: the global norm
clip, BertAdam and the EMA shadow, and the per-step random generator.

Frozen from svpc_torch/train/{optim,step}.py at commit aeb5374 (one
process, float32 state; published as src/rtransformer/optimization.py of
awkrail/svpc): BertAdam has no bias correction, clips each gradient to
norm 1 inside the step and adds the decoupled weight decay to the update;
the loop clips the global norm first.  It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_F32 = np.float32


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator a step draws its dropout masks and Gumbel noise from,
    seeded from (seed, step) as the program seeds it."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(
        int(mixed) & (2 ** 63 - 1))


def warmup_linear(step: int, warmup: float, t_total: int) -> np.float32:
    progress = _F32(step) / _F32(t_total)
    if progress < _F32(warmup):
        return progress / _F32(warmup)
    return max((progress - _F32(1.0)) / _F32(warmup - 1.0), _F32(0.0))


def decays(name: str) -> bool:
    return "bias" not in name and "LayerNorm.weight" not in name


class ReferenceOptimizer:
    """Global clip, BertAdam and EMA over named float32 parameters."""

    def __init__(self, params: Dict[str, torch.Tensor], t: Dict):
        """``t``: lr, lr_warmup_proportion, t_total, adam_b1, adam_b2,
        adam_eps, weight_decay, grad_clip, ema_decay."""
        self.params, self.t = params, t
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.ema = {n: p.detach().clone() for n, p in params.items()}
        self.step = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        t = self.t
        names = list(self.params)
        norms = [grads[n].norm() for n in names]
        total = torch.sqrt(sum(x * x for x in norms))
        scale = torch.clamp(t["grad_clip"] / (total + 1e-6), max=1.0)
        gs = [grads[n] * scale for n in names]
        gs = [g * torch.clamp(1.0 / (g.norm() + 1e-6), max=1.0) for g in gs]
        lr = float(_F32(t["lr"]) * warmup_linear(
            self.step, t["lr_warmup_proportion"], t["t_total"]))
        b1, b2 = t["adam_b1"], t["adam_b2"]
        for n, g in zip(names, gs):
            self.m[n] = b1 * self.m[n] + (1 - b1) * g
            self.v[n] = b2 * self.v[n] + (1 - b2) * g * g
            u = self.m[n] / (self.v[n].sqrt() + t["adam_eps"])
            if t["weight_decay"] > 0 and decays(n):
                u = u + t["weight_decay"] * self.params[n]
            self.params[n].add_(-lr * u)
        s = _F32(self.step)
        d = min(_F32(t["ema_decay"]), (_F32(1.0) + s) / (_F32(10.0) + s))
        for n, p in self.params.items():
            self.ema[n] = float(_F32(1.0) - d) * p + float(d) * self.ema[n]
        self.step += 1

"""Random weights from the run's seed, made on the device in two draws.

The initializers are the program's (svpc_torch/model/svpc.py
``init_parameters`` at commit aeb5374): dense kernels and embedding tables
N(0, initializer_range), biases 0, LayerNorm gains 1, the action-embedding
tables N(0, initializer_range), the LSTM's weights and biases
U(-1/sqrt(H), 1/sqrt(H)).  The tensors are laid out by the reference
model's parameters, whose names are the program's, and cut from one
normal and one uniform draw of a ``torch.Generator`` on the device.  The
same seed on the same device gives the same weights, so the reference
makes its own copy after the window.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from pbench.reference.model import BiLSTM, LayerNorm, ReferenceModel


def _kinds(model: nn.Module) -> Dict[str, str]:
    kinds = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(mod, LayerNorm):
                kinds[name] = "one" if pname == "weight" else "zero"
            elif isinstance(mod, BiLSTM):
                kinds[name] = "uniform"
            elif pname == "bias":
                kinds[name] = "zero"
            else:  # dense kernels, embedding tables, action embeddings
                kinds[name] = "normal"
    return kinds


def make_weights(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of configuration ``c`` for ``seed`` on ``device``."""
    with torch.device("meta"):
        skeleton = ReferenceModel(c)
    shapes = {n: tuple(p.shape) for n, p in skeleton.named_parameters()}
    kinds = _kinds(skeleton)
    gen = torch.Generator(device=device).manual_seed(int(
        np.random.SeedSequence([seed, 3]).generate_state(1, np.uint64)[0])
        & (2 ** 63 - 1))
    count = lambda kind: sum(math.prod(shapes[n]) for n in shapes
                             if kinds[n] == kind)
    normal = torch.randn(count("normal"), generator=gen, device=device) \
        * c["initializer_range"]
    bound = 1.0 / math.sqrt(c["hidden_size"])
    uniform = (torch.rand(count("uniform"), generator=gen, device=device)
               * 2.0 - 1.0) * bound
    out, at = {}, {"normal": 0, "uniform": 0}
    for n, shape in shapes.items():
        k = kinds[n]
        if k in at:
            size = math.prod(shape)
            src = normal if k == "normal" else uniform
            out[n] = src[at[k]:at[k] + size].view(shape)
            at[k] += size
        else:
            out[n] = torch.full(shape, 1.0 if k == "one" else 0.0,
                                device=device)
    return out


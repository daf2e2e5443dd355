"""The textual re-simulator's 1-layer bidirectional LSTM (reference
model.py:865, :1022-1024): the port of svpc_tpu/model/lstm.py.

Parameters keep torch.nn.LSTM's names (``weight_ih_l0`` ...
``bias_hh_l0_reverse``, gate chunks [i, f, g, o], init U(-1/sqrt(H),
1/sqrt(H))), so ``vivt`` checkpoints load strictly.  The forward is the
masked carry-hold recurrence: a padded step leaves (h, c) untouched and
outputs ``h_new * m``, so the states at real steps equal those of the
unpadded sequence in both directions.  The step loop (S <= 16) is plain
tensor code, the ``lax.scan`` of the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

_SUFFIXES = ("l0", "l0_reverse")


class BiLSTM(nn.Module):
    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        g = 4 * hidden_size
        for sfx in _SUFFIXES:
            self.register_parameter(f"weight_ih_{sfx}",
                                    nn.Parameter(torch.zeros(g, input_size)))
            self.register_parameter(f"weight_hh_{sfx}",
                                    nn.Parameter(torch.zeros(g, hidden_size)))
            self.register_parameter(f"bias_ih_{sfx}",
                                    nn.Parameter(torch.zeros(g)))
            self.register_parameter(f"bias_hh_{sfx}",
                                    nn.Parameter(torch.zeros(g)))

    def _direction(self, x, mask, sfx: str, reverse: bool) -> torch.Tensor:
        w_ih, w_hh = getattr(self, f"weight_ih_{sfx}"), \
            getattr(self, f"weight_hh_{sfx}")
        b_ih, b_hh = getattr(self, f"bias_ih_{sfx}"), \
            getattr(self, f"bias_hh_{sfx}")
        b, s, _ = x.shape
        h = x.new_zeros(b, self.hidden_size)
        c = x.new_zeros(b, self.hidden_size)
        x_proj = x @ w_ih.T + b_ih               # (B, S, 4H), all steps at once
        outs = [None] * s
        for t in (range(s - 1, -1, -1) if reverse else range(s)):
            gates = x_proj[:, t] + h @ w_hh.T + b_hh
            i, f, g, o = gates.chunk(4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            m = mask[:, t, None]
            h = torch.where(m > 0, h_new, h)
            c = torch.where(m > 0, c_new, c)
            outs[t] = h_new * m
        return torch.stack(outs, dim=1)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x (B, S, D), mask (B, S) -> (B, S, 2H) = [forward ; backward]."""
        if mask is None:
            mask = x.new_ones(x.shape[:2])
        mask = mask.to(x.dtype)
        return torch.cat([self._direction(x, mask, sfx, sfx != "l0")
                          for sfx in _SUFFIXES], dim=-1)

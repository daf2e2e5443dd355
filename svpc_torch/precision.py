"""Numerics policy and device choice: the port of svpc_tpu/precision.py.

``compute_dtype == "float32"`` is the parity path: matrix products run in
full float32, with TF32 off for both matmuls and cuDNN (the counterpart of
svpc_tpu's "highest" matmul precision).  ``"bfloat16"`` is the fast path:
parameters stay float32, activations are bfloat16 from the model's entry
points on, and each product runs in the dtype svpc_tpu gives it (the
modules cast explicitly; ``torch.autocast`` is not used, its operator
lists are not svpc_tpu's map).  A bfloat16 product accumulates in float32,
as the MXU and XLA's CPU dot do; the float32 products that remain in
bfloat16 mode (the head's softmax input, the copy scatter, the textual
re-simulator) keep TF32 off as on the parity path.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from svpc_torch.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def check_compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The compute dtype of ``cfg`` (float32 or bfloat16; anything else
    raises).  Pins float32 matmuls to full precision (TF32 off) and
    bfloat16 matmuls to float32 accumulation, process-wide."""
    if cfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: use one of "
                         f"{sorted(_DTYPES)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return _DTYPES[cfg.compute_dtype]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card.  Asking for ``cuda`` where there is none
    raises: the port never carries on on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

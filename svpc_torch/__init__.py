"""svpc_torch — the PyTorch / CUDA port of svpc_tpu for NVIDIA Hopper.

The JAX package ``svpc_tpu`` stays the reference; this package mirrors
its module names (``config``, ``data/``, ``model/``, ``ops/``,
``decode/``, ``train/``, ``evaluation/``, ``serving``, ``cli/``) and is held against it by
``tests/test_torch_*.py``.
It imports torch and never jax, flax, nltk or anything of ``svpc_tpu``.

Entry points (``cli.serve``, ``cli.train``, ``cli.evaluate``,
``cli.caption``) run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for ``cuda`` without a card raises.
Every deterministic attention on a CUDA tensor runs the hand-written kernel
in ``csrc/fused_attention.cu`` (``ops/attention.py``); on a CPU tensor, and
in training (non-deterministic, under autograd), the plain PyTorch version
runs.
"""

__version__ = "0.1.0"

from svpc_torch.config import Config, DataConfig, ModelConfig, TrainConfig  # noqa: F401

"""Masked multi-head attention: the hand-written CUDA kernel and its plain
PyTorch version.

``fused_attention`` is the port of the TPU kernel
svpc_tpu/ops/pallas_attention.py::fused_attention (``_flash_kernel``, the
repo's one ``pl.pallas_call``).  On a CUDA tensor it launches
``csrc/fused_attention.cu`` (built on first use by ops/_build.py) or
raises; on a CPU tensor it runs ``attention_plain``.  There is no
fallback from the card to the plain version.  ``_plan`` chooses the
kernel's path and launch geometry: the tensor-core tile path for
Lq > ``DECODE_MAX_LQ``, the register-only decode path otherwise.

Layout, as in the JAX package: q (N, Lq, H), k/v (N, Lk, H), mask
(N, 1, Lk) key-padding or (N, Lq, Lk) full, float 1/0.  Output
(N, Lq, H).  Semantics: additive ``(1 - m) * -1e4`` mask, softmax in f32
(reference model.py:181-220 via svpc_tpu/model/layers.py:53-83).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

# kernel launches since the last reset_launches(); each wrapper adds one
# where it launches its kernel and nowhere else
# (the path counters split the first one by the path that ran)
LAUNCHES = {"fused_attention": 0, "fused_attention.tile": 0,
            "fused_attention.decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, num_heads: int,
                    dropout_p: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """The plain version: svpc_tpu/model/layers.py::attention_core.

    Scores and softmax in f32 whatever the input dtype; probabilities are
    cast back to v's dtype before the value product.  ``dropout_p`` > 0
    drops probabilities (the training path; the kernel has no dropout)."""
    n, lq, h = q.shape
    lk = k.shape[1]
    dh = h // num_heads
    qh = q.reshape(n, lq, num_heads, dh).transpose(1, 2)
    kh = k.reshape(n, lk, num_heads, dh).transpose(1, 2)
    vh = v.reshape(n, lk, num_heads, dh).transpose(1, 2)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    scores = scores / math.sqrt(dh)
    scores = scores + (1.0 - mask[:, None].float()) * -10000.0
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    if dropout_p > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout_p
        probs = probs * keep / (1.0 - dropout_p)
    ctx = torch.matmul(probs, vh)
    return ctx.transpose(1, 2).reshape(n, lq, h)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"tile": 0, "decode": 1}

DECODE_MAX_LQ = 4     # Lq at or below this takes the decode path
TILE_ROWS = 16        # query rows a consumer warp of the tile path owns
TILE_MAX_WARPS = 8    # consumer warps a tile block: up to 128 query rows
# f32 rows wider than 64: 128 rows with a full mask would take 270 KB of
# shared memory, past the 227 KB a block may have on the H100; 64 take 201
TILE_MAX_WARPS_F32_WIDE = 4
# (sequence, head, query row) warps a decode block; the warps share
# nothing, so small blocks spread a cached step's 1152 warps (N=96) evenly
# over the 132 SMs
DECODE_WARPS = 2


class Plan(NamedTuple):
    path: str                     # "tile" or "decode"
    grid: Tuple[int, int, int]
    block: Tuple[int, int, int]
    warps: int                    # consumer warps (tile), warps (decode)


def _plan(n: int, lq: int, num_heads: int, dh: int,
          dtype: torch.dtype) -> Plan:
    """The kernel's path and launch geometry for one call.

    Tile: one block per (query block, head, sequence), the query blocks
    as few as 128-row blocks (64-row in f32 with dh > 64) allow and
    evenly filled, plus one producer warp.  A bf16 head row that is not
    a whole number of 16-byte units cannot be bulk-copied, so it takes the
    decode path at any Lq."""
    if lq <= DECODE_MAX_LQ or (dtype == torch.bfloat16 and dh % 8):
        blocks = -(-n * num_heads * lq // DECODE_WARPS)
        return Plan("decode", (blocks, 1, 1), (DECODE_WARPS * 32, 1, 1),
                    DECODE_WARPS)
    groups = -(-lq // TILE_ROWS)
    max_warps = (TILE_MAX_WARPS_F32_WIDE
                 if dtype == torch.float32 and dh > 64 else TILE_MAX_WARPS)
    blocks = -(-groups // max_warps)
    warps = -(-groups // blocks)
    return Plan("tile", (blocks, num_heads, n), ((warps + 1) * 32, 1, 1),
                warps)


def _bind(lib) -> None:
    fn = lib.svpc_fused_attention
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _library():
    from svpc_torch.ops._build import load_library
    lib = load_library("fused_attention")
    if lib.svpc_fused_attention.argtypes is None:
        _bind(lib)
    return lib


def _check(q, k, v, mask, num_heads):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or mask.dim() != 3:
        raise ValueError("fused_attention: q, k, v and mask must be 3-D")
    n, lq, h = q.shape
    lk = k.shape[1]
    if k.shape != (n, lk, h) or v.shape != (n, lk, h):
        raise ValueError(f"fused_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if mask.shape[0] != n or mask.shape[1] not in (1, lq) \
            or mask.shape[2] != lk:
        raise ValueError(f"fused_attention: mask {tuple(mask.shape)} is "
                         f"neither ({n}, 1, {lk}) nor ({n}, {lq}, {lk})")
    if h % num_heads:
        raise ValueError(f"fused_attention: H={h} not divisible by "
                         f"num_heads={num_heads}")
    dh = h // num_heads
    if dh > 128 or dh % 4:
        raise ValueError(f"fused_attention: head width {dh} unsupported "
                         "(needs dh <= 128 and dh % 4 == 0)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"fused_attention: q/k/v must share float32 or "
                        f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if mask.dtype not in (torch.float32, q.dtype):
        raise TypeError(f"fused_attention: mask dtype {mask.dtype} must be "
                        f"float32 or {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"fused_attention: {name} needs a contiguous "
                             "last (hidden) dimension")
    if n > 65535 or num_heads > 65535:
        raise ValueError("fused_attention: N and num_heads must be <= 65535")
    return n, lq, lk, h, dh


def _check_alignment(q, k, v) -> None:
    """Bulk copies and vector loads need 16-byte aligned bases and row
    strides (a stride of a length-1 dimension is never used)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        size = t.element_size()
        if (t.data_ptr() % 16
                or t.shape[0] > 1 and t.stride(0) * size % 16
                or t.shape[1] > 1 and t.stride(1) * size % 16):
            raise ValueError(f"fused_attention: {name} needs a 16-byte "
                             "aligned base and row strides")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Deterministic masked attention -> (N, Lq, H).

    CPU tensors: ``attention_plain``.  CUDA tensors: the hand-written
    kernel's tile or decode path (``_plan``), or an exception (wrong
    device, dtype, shape, layout, alignment, or a refused launch)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mask, num_heads)
    if q.device.type != "cuda":
        raise RuntimeError(f"fused_attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v), ("mask", mask)):
        if t.device != q.device:
            raise RuntimeError(f"fused_attention: {name} on {t.device}, "
                               f"q on {q.device}")
    n, lq, lk, h, dh = _check(q, k, v, mask, num_heads)
    _check_alignment(q, k, v)
    plan = _plan(n, lq, num_heads, dh, q.dtype)
    # a key-padding mask (N, 1, Lk) reads row 0 for every query
    m_sq = mask.stride(1) if mask.shape[1] == lq and lq > 1 else 0
    out = torch.empty((n, lq, h), dtype=q.dtype, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.svpc_fused_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
            out.data_ptr(), _DTYPES[q.dtype],
            0 if mask.dtype == torch.float32 else 1,
            n, lq, lk, num_heads, dh,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1),
            mask.stride(0), m_sq, mask.stride(2),
            1.0 / math.sqrt(dh), _PATHS[plan.path], plan.grid[0],
            plan.warps, stream)
    if err != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA "
                           f"error {err} (N={n} Lq={lq} Lk={lk} H={h} "
                           f"heads={num_heads} {q.dtype} {plan})")
    LAUNCHES["fused_attention"] += 1
    LAUNCHES["fused_attention." + plan.path] += 1
    return out

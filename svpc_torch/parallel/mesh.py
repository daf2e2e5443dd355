"""The dp x tp mesh and its sharding rules on ``torch.distributed``: the
port of svpc_tpu/parallel/mesh.py.

svpc_tpu places arrays on a ``jax.sharding.Mesh`` and lets GSPMD insert
the collectives.  Here each process is one mesh position: ``make_mesh``
gives this rank's ``(dp_index, tp_index)`` and the process groups of its
dp and tp axes, with tp innermost (rank = dp_index * tp + tp_index), as
svpc_tpu orders its axes (the per-product tp all-reduces on the nearest
links, the one gradient all-reduce a step across dp).  The model holds
only its tp shards (``shard_module``), every rank runs its dp block of
the batch (``shard_batch``), and the collectives are written out
(parallel/collectives.py).

The partition rules are svpc_tpu's, keyed by the port's state-dict names
and written for torch's layouts: a ``Linear.weight`` is (out, in), the
transpose of a flax kernel, so svpc_tpu's ``P(None, "tp")`` on a
column-parallel kernel is dim 0 here.  A spec is a tuple with one entry
per dim: ``None``, ``"tp"``, ``"dp"`` or ``("tp", "dp")``.

Losses are sums over examples, so the dp all-reduce of gradients gives
the one-process gradient up to summation order, and every random draw of
a step (dropout, Gumbel noise) is made over the global shape and sliced
(``GlobalDraws``), so a dp or tp run repeats the one-process trajectory.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from svpc_torch.parallel.collectives import gather_dim
from svpc_torch.precision import resolve_device

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the dp x tp mesh and its axes' groups."""
    dp_size: int
    tp_size: int
    dp_index: int
    tp_index: int
    dp_group: Any = None
    tp_group: Any = None

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes logs, predictions and checkpoints."""
        return self.dp_index == 0 and self.tp_index == 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device=None) -> torch.device:
    """This process's device: ``None`` or ``"cuda"`` is ``cuda:LOCAL_RANK``
    (torchrun's variable; 0 without it), ``"cuda:i"`` pins the rank to
    card i, ``"cpu"`` is the CPU.  A missing card raises
    (precision.resolve_device)."""
    if device is None or str(device) == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    return resolve_device(device)


def init_distributed(backend: Optional[str] = None, device=None,
                     timeout_s: float = 300.0) -> None:
    """The default process group from torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``); one process without
    them rendezvouses with itself on a free local port.  The backend is
    NCCL for a CUDA device and gloo for the CPU unless given; a gloo group
    gets ``timeout_s``, so a rank that dies does not hang the others.
    Nothing happens when a group exists."""
    if dist.is_initialized():
        return
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if "MASTER_ADDR" in os.environ:
        init_method = "env://"
    elif world == 1:
        init_method = f"tcp://127.0.0.1:{free_port()}"
    else:
        raise RuntimeError(f"WORLD_SIZE={world} without MASTER_ADDR: start "
                           "the ranks with torchrun")
    kw = {}
    if backend == "gloo":
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, **kw)


def close_distributed() -> None:
    """Tear down the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(dp_size: Optional[int] = None, tp_size: int = 1) -> Mesh:
    """The dp x tp mesh over every rank of the default group (which
    ``init_distributed`` makes): ``dp_size * tp_size`` must be the world
    size (``dp_size=None`` takes the rest of it)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed() (or start under torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp_size is None:
        dp_size = max(world // tp_size, 1)
    if dp_size * tp_size != world:
        raise ValueError(f"mesh {dp_size}x{tp_size} needs {dp_size * tp_size}"
                         f" processes, the world has {world}")
    dp_group = tp_group = None
    # every rank creates every group, in the same order
    for d in range(dp_size):
        g = dist.new_group([d * tp_size + t for t in range(tp_size)])
        if rank // tp_size == d:
            tp_group = g
    for t in range(tp_size):
        g = dist.new_group([d * tp_size + t for d in range(dp_size)])
        if rank % tp_size == t:
            dp_group = g
    return Mesh(dp_size, tp_size, rank // tp_size, rank % tp_size,
                dp_group, tp_group)


# ---------------------------------------------------------------------- #
# batches
# ---------------------------------------------------------------------- #

def local_dp_shards(mesh: Mesh) -> set:
    """The dp blocks this process builds under ``multihost_sharded_data``
    (``pack_examples(only_shards=...)``): its own."""
    return {mesh.dp_index}


def shard_batch(mesh: Mesh, batch: dict, n_leading: int = 0) -> dict:
    """This rank's dp block of a numpy batch built as the global one:
    every array's batch axis (after ``n_leading`` stacked axes) is cut in
    ``dp_size`` contiguous blocks, per-video ``(B, ...)`` and packed
    per-clip ``(N * dp, ...)`` arrays alike (``pack_examples(dp_shards=
    dp)`` packs each block on its own), and the packed ``clip_video``
    indices are made local to the block (a padding clip points at the
    block's first video).

    svpc_tpu's ``shard_batch``, ``assemble_global_batch`` and
    ``shard_batch_multihost`` in one: every rank either builds the
    identical global batch and keeps its rows (the default), or builds
    only its own block (``only_shards``), which is byte-equal to the same
    rows of the global build."""
    dp, i = mesh.dp_size, mesh.dp_index
    out = {}
    for k, v in batch.items():
        n = v.shape[n_leading]
        if n % dp:
            raise ValueError(f"{k}: batch axis {n} not divisible by "
                             f"dp={dp}")
        index = (slice(None),) * n_leading + (slice(i * n // dp,
                                                     (i + 1) * n // dp),)
        out[k] = v[index]
    if "clip_video" in out:
        bs = batch["step_mask"].shape[n_leading] // dp
        out["clip_video"] = np.where(out["clip_mask"] > 0,
                                     out["clip_video"] - i * bs,
                                     0).astype(out["clip_video"].dtype)
    return out


# ---------------------------------------------------------------------- #
# tensor parallelism
# ---------------------------------------------------------------------- #

def param_partition_spec(name: str) -> Spec:
    """svpc_tpu's Megatron rule for one parameter, by its state-dict name,
    in torch's layout:

      * attention Q/K/V weights (out, in) row-split = head-wise, their
        biases with them; the encoder attention's output projection
        column-split (its partial products are all-reduced);
      * the FFN intermediate weight (+bias) row-split, the FFN output
        projection column-split (also the decoder layer's output block,
        as svpc_tpu's rule reads);
      * the word, token-type and action embedding tables (V, D) split
        over their rows (vocab);
      * the LM head's vocab projection (V, H) and its bias split over
        vocab.

    Everything else (LayerNorms, the LSTM, the reasoner projections, the
    pointer-generator) replicates: ``()``."""
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    if parent in ("query", "key", "value"):
        return ("tp", None) if leaf == "weight" else ("tp",)
    if ".attention.output.dense." in name:
        return (None, "tp") if leaf == "weight" else ()
    if name.endswith("word_embeddings.weight") or \
            name == "token_type_embeddings.weight" or \
            leaf == "action_embeddings":
        return ("tp", None)
    if name == "decoder_classifier.decoder.weight":
        return ("tp", None)
    if name == "decoder_classifier.bias":
        return ("tp",)
    if ".hidden_intermediate.dense." in name:
        return ("tp", None) if leaf == "weight" else ("tp",)
    if name.endswith("output.dense.weight") and "attention" not in name:
        return (None, "tp")
    return ()


def _resolve_spec(spec: Spec, shape: tuple, axis_sizes: Dict[str, int]
                  ) -> Spec:
    """``spec`` padded to the tensor's rank, axes the mesh lacks dropped;
    a tp dim that does not divide its axis replicates the whole tensor
    (svpc_tpu's all-or-nothing fallback)."""
    dims = [ax if ax in axis_sizes else None for ax in spec]
    dims += [None] * (len(shape) - len(dims))
    for d, ax in enumerate(dims):
        if ax is not None and shape[d] % axis_sizes[ax]:
            return (None,) * len(shape)
    return tuple(dims)


def tp_dim(spec: Spec) -> Optional[int]:
    """The dim a resolved spec splits over tp, or None."""
    for d, ax in enumerate(spec):
        if ax == "tp" or (isinstance(ax, tuple) and "tp" in ax):
            return d
    return None


def dp_dim(spec: Spec) -> Optional[int]:
    """The dim a ZeRO-1 spec splits over dp, or None."""
    for d, ax in enumerate(spec):
        if ax == "dp" or (isinstance(ax, tuple) and "dp" in ax):
            return d
    return None


def resolved_spec(name: str, shape: tuple, mesh: Mesh) -> Spec:
    return _resolve_spec(param_partition_spec(name), tuple(shape),
                         {"tp": mesh.tp_size} if mesh.tp_size > 1 else {})


def zero1_partition_spec(name: str, shape: tuple,
                         axis_sizes: Dict[str, int]) -> Spec:
    """ZeRO-1 rule for one Adam moment / EMA leaf: its parameter's tp
    layout, with dp folded into the first free dim that dp divides, or
    onto the tp dim when dp * tp divides it; ``dp`` stays off a leaf with
    no such dim (scalars, tiny biases).  Gradients stay whole, so both
    norm clips read full gradients.  The dims are torch's: the dim chosen
    may be another than svpc_tpu's (the update is elementwise), the
    leaves sharded and the bytes a rank holds are the same."""
    dp = axis_sizes.get("dp", 1)
    tp = axis_sizes.get("tp", 1)
    spec = list(_resolve_spec(param_partition_spec(name), tuple(shape),
                              {k: v for k, v in axis_sizes.items()
                               if k == "tp"}))
    for d in range(len(shape)):
        if spec[d] is None and shape[d] > 0 and shape[d] % dp == 0:
            spec[d] = "dp"
            break
        if spec[d] == "tp" and shape[d] % (dp * tp) == 0:
            spec[d] = ("tp", "dp")
            break
    return tuple(spec)


def tp_dims(full_shapes: Dict[str, tuple], mesh: Optional[Mesh]
            ) -> Dict[str, Optional[int]]:
    """Each parameter's tp-split dim (None: replicated) on ``mesh``."""
    if mesh is None or mesh.tp_size == 1:
        return {n: None for n in full_shapes}
    return {n: tp_dim(resolved_spec(n, s, mesh))
            for n, s in full_shapes.items()}


def zero1_dims(full_shapes: Dict[str, tuple], mesh: Optional[Mesh]
               ) -> Dict[str, Optional[int]]:
    """Each Adam moment / EMA leaf's dp-split dim under ZeRO-1 (None:
    held whole by every dp rank)."""
    if mesh is None:
        return {n: None for n in full_shapes}
    sizes = {"dp": mesh.dp_size, "tp": mesh.tp_size}
    return {n: dp_dim(zero1_partition_spec(n, s, sizes))
            for n, s in full_shapes.items()}


def _block(t: torch.Tensor, dim: Optional[int], parts: int, index: int):
    if dim is None or parts == 1:
        return t
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n)


def tp_slice(t: torch.Tensor, dim: Optional[int], mesh: Mesh):
    """This rank's tp shard of a full tensor (a view)."""
    return t if dim is None else _block(t, dim, mesh.tp_size, mesh.tp_index)


def dp_slice(t: torch.Tensor, dim: Optional[int], mesh: Mesh):
    """This rank's ZeRO-1 dp slice of a tp-local tensor (a view)."""
    return t if dim is None else _block(t, dim, mesh.dp_size, mesh.dp_index)


def shard_params(state_dict: Dict[str, torch.Tensor], mesh: Mesh,
                 report: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """This rank's tp shards of a full state dict (copies).  ``report``
    collects, for each tensor a rule targets, its resolved spec, or
    ``"replicated(shape)"`` where the divisibility fallback replicated
    it."""
    out = {}
    for name, t in state_dict.items():
        rule = param_partition_spec(name)
        spec = resolved_spec(name, t.shape, mesh)
        if report is not None and mesh.tp_size > 1 and \
                any(ax is not None for ax in rule):
            report[name] = (str(spec) if tp_dim(spec) is not None
                            else f"replicated{tuple(t.shape)}")
        out[name] = tp_slice(t, tp_dim(spec), mesh).clone()
    return out


def gather_params(state_dict: Dict[str, torch.Tensor],
                  dims: Dict[str, Optional[int]], mesh: Optional[Mesh]
                  ) -> Dict[str, torch.Tensor]:
    """The full tensors from this rank's tp shards (``dims`` from
    ``tp_dims``); every rank of the tp group must call it."""
    return {n: (t if dims.get(n) is None or mesh is None
                or mesh.tp_size == 1
                else gather_dim(t, dims[n], mesh.tp_group))
            for n, t in state_dict.items()}


def shard_module(model: nn.Module, mesh: Mesh,
                 report: Optional[dict] = None) -> Dict[str, Optional[int]]:
    """Cut ``model``'s parameters to this rank's tp shards in place and
    tag every submodule with ``mesh`` and ``tp_dims`` ({parameter name:
    split dim}), which the modules' forwards read (model/layers.py,
    model/embeddings.py, model/reasoner.py).  Returns each parameter's
    split dim (``tp_dims``)."""
    dims = tp_dims({n: tuple(p.shape) for n, p in model.named_parameters()},
                   mesh)
    local = shard_params(dict(model.named_parameters()), mesh, report)
    for mod_name, mod in model.named_modules():
        mod.mesh = mesh
        mod.tp_dims = {}
        for pname, p in list(mod._parameters.items()):
            name = f"{mod_name}.{pname}" if mod_name else pname
            if p is None or dims.get(name) is None:
                continue
            mod.tp_dims[pname] = dims[name]
            mod._parameters[pname] = nn.Parameter(
                local[name].detach(), requires_grad=p.requires_grad)
    return dims


def module_tp_dim(module: nn.Module, pname: str = "weight") -> Optional[int]:
    """The dim of ``module.<pname>`` split over tp, or None."""
    return getattr(module, "tp_dims", {}).get(pname)


# ---------------------------------------------------------------------- #
# random draws over the global shape
# ---------------------------------------------------------------------- #

class GlobalDraws:
    """A generator that draws as the one-process run draws: each
    ``uniform`` draws the global shape (dim 0, the batch or clip axis,
    ``dp_size`` times this rank's; a tp-split dim ``tp_size`` times) from
    the step's generator and keeps this rank's block, so a dp or tp run
    consumes the stream in the same order and gets the same masks and
    Gumbel noise as svpc_tpu's jitted step does with its global-shape
    keys."""

    def __init__(self, generator: torch.Generator, mesh: Mesh):
        self.generator, self.mesh = generator, mesh

    @property
    def device(self):
        return self.generator.device

    def get_state(self):
        return self.generator.get_state()

    def set_state(self, state) -> None:
        self.generator.set_state(state)

    def fresh(self) -> "GlobalDraws":
        return GlobalDraws(torch.Generator(device=self.device), self.mesh)

    def uniform(self, shape, device, tp_split: Optional[int] = None):
        m = self.mesh
        full = list(shape)
        full[0] *= m.dp_size
        if tp_split is not None:
            full[tp_split] *= m.tp_size
        u = torch.rand(full, generator=self.generator, device=device)
        u = _block(u, 0, m.dp_size, m.dp_index)
        return _block(u, tp_split, m.tp_size, m.tp_index)


def uniform(shape, generator, device, tp_split: Optional[int] = None
            ) -> torch.Tensor:
    """``torch.rand(shape)`` from ``generator``; a ``GlobalDraws`` draws
    the global shape and returns this rank's block (``tp_split``: the dim
    this rank holds a tp share of, e.g. the attention heads)."""
    if isinstance(generator, GlobalDraws):
        return generator.uniform(shape, device, tp_split)
    return torch.rand(shape, generator=generator, device=device)


def fresh_generator(like):
    """An unseeded generator of ``like``'s kind on its device."""
    if isinstance(like, GlobalDraws):
        return like.fresh()
    return torch.Generator(device=like.device)

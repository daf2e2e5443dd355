"""GPipe pipeline parallelism over the model's homogeneous trunks: the port
of svpc_tpu/parallel/pipeline.py.

svpc_tpu cuts a stack of identical layers into ``pp`` contiguous stages on
a mesh axis and runs the microbatch schedule inside ``jax.shard_map``,
``lax.ppermute`` moving activations stage to stage; JAX derives the
backward pass by transposition.  Here each stage is a process (a rank of
the mesh's pp group) holding only its own block of layers
(``SVPCModel.shard``), the schedule is a Python loop of ``n + pp - 1``
ticks, the hand-offs are the autograd functions of
parallel/collectives.py (``ppermute``, ``trunk_entry``, ``trunk_exit``),
and autograd runs the reversed pipeline.  Every loss here is a sum over
examples, so microbatching is exact, as gradient accumulation is.

Every stage computes every tick, bubbles included, and the stage enters
only through tensor gates (``torch.where``), so the autograd graph, and
with it the order of every pp and tp collective in the forward and the
backward pass, is the same on every rank.  A bubble runs its layers on
zeros (stage s > 0 before its first microbatch arrives: a fully masked
row, whose softmax is uniform and whose LayerNorm is 0) or on a repeat of
the last microbatch (stage 0 after the feed drains); neither is
non-finite, and the emit gate discards both.

Dropout: svpc_tpu folds a key per microbatch, so its pp run is exact to
its pp=1 run only at dropout 0.  The port's ``StageDraws`` draws each
trunk layer's masks over the whole (global) batch from the step's
generator, in the order the sequential trunk draws them, and hands each
microbatch its rows, so a pp run repeats the port's pp=1 run with dropout
on up to summation order.

At the flagship's 2 + 2 layers (pp=2: one layer a stage) the auto count
of 4 microbatches runs 5 ticks: the bubble is 1/5 of the schedule and a
stage computes 1.25 times its useful trunk work.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from svpc_torch.parallel.collectives import ppermute, trunk_exit
from svpc_torch.parallel.mesh import PP_TRUNK_KEYS, uniform

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------- #
# microbatches
# ---------------------------------------------------------------------- #

def auto_microbatches(n: int, requested: int, dp: int, pp: int) -> int:
    """Microbatch count for a (global) batch axis of ``n`` rows under dp
    shards: it must divide ``n // dp`` (every microbatch takes an equal
    slice of every dp shard).  ``requested`` <= 0 targets ``2 * pp``;
    either way the result is clamped to the largest feasible divisor,
    never an error (a requested count that moves is logged)."""
    per = max(n // max(dp, 1), 1)
    want = requested if requested > 0 else 2 * pp
    k = max(1, min(want, per))
    while per % k:
        k -= 1
    if requested > 0 and k != requested:
        logger.info("pp_microbatches=%d adjusted to %d (must divide the "
                    "per-dp-shard batch axis of %d rows)", requested, k, per)
    return k


def split_microbatches(x, n_micro: int, dp: int = 1):
    """``(N, ...)`` -> ``(n_micro, N / n_micro, ...)``, microbatch i taking
    the i-th equal slice of every dp shard of the batch axis;
    ``merge_microbatches`` is the inverse.  A rank holding only its dp
    block splits it with ``dp=1``.  numpy arrays or tensors."""
    N = x.shape[0]
    m = N // dp // n_micro
    x = x.reshape((dp, n_micro, m) + tuple(x.shape[1:])).swapaxes(0, 1)
    return x.reshape((n_micro, dp * m) + tuple(x.shape[3:]))


def merge_microbatches(x, dp: int = 1):
    """Inverse of :func:`split_microbatches`."""
    n_micro, bm = x.shape[:2]
    m = bm // dp
    x = x.reshape((n_micro, dp, m) + tuple(x.shape[2:])).swapaxes(0, 1)
    return x.reshape((dp * n_micro * m,) + tuple(x.shape[3:]))


# ---------------------------------------------------------------------- #
# stacked <-> per-layer trunk trees (svpc_tpu's pipeline-resident layout)
# ---------------------------------------------------------------------- #

_LAYER_KEY = re.compile(r"layer_(\d+)$")


def _layer_indices(d: dict) -> Optional[List[int]]:
    """Sorted layer indices when ``d`` holds a complete layer_0..layer_{L-1}
    family (L >= 2), else None."""
    idx = sorted(int(m.group(1)) for k in d
                 if isinstance(k, str) and (m := _LAYER_KEY.match(k)))
    return idx if len(idx) > 1 and idx == list(range(len(idx))) else None


def _map_leaves(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map_leaves(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _stack_leaf(*xs):
    if isinstance(xs[0], torch.Tensor):
        return torch.stack(xs)
    return np.stack([np.asarray(x) for x in xs])


def _map_dicts(fn, tree):
    """``fn`` on every dict node, bottom-up; tuples and lists (NamedTuples
    keep their type) are walked through."""
    if isinstance(tree, dict):
        return fn({k: _map_dicts(fn, v) for k, v in tree.items()})
    if isinstance(tree, tuple):
        vals = [_map_dicts(fn, v) for v in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, list):
        return [_map_dicts(fn, v) for v in tree]
    return tree


def stack_trunk_params(tree, trunk_keys=PP_TRUNK_KEYS):
    """svpc_tpu's pipeline-resident layout: the ``layer_0..layer_{L-1}``
    families of the pipelined trunks (``trunk_keys`` subtrees, wherever
    they appear) collapse into one ``layers`` subtree with a leading layer
    axis; ``step_wise_encoder`` keeps its per-layer storage.  On nested
    dicts of numpy arrays or tensors; ``unstack_trunk_params`` is the
    inverse."""
    def fn(d):
        out = None
        for k, v in d.items():
            if k not in trunk_keys or not isinstance(v, dict):
                continue
            idx = _layer_indices(v)
            if idx is None:
                continue
            stacked = {kk: vv for kk, vv in v.items()
                       if _LAYER_KEY.match(kk) is None}
            stacked["layers"] = _map_leaves(
                _stack_leaf, *[v[f"layer_{i}"] for i in idx])
            out = dict(d if out is None else out)
            out[k] = stacked
        return d if out is None else out

    return _map_dicts(fn, tree)


def unstack_trunk_params(tree):
    """Inverse of :func:`stack_trunk_params`: ``layers`` subtrees split
    back into ``layer_i`` families (leading-axis slices)."""
    def fn(d):
        if "layers" not in d or not isinstance(d["layers"], dict):
            return d
        stacked = d["layers"]
        leaf = stacked
        while isinstance(leaf, dict):
            leaf = next(iter(leaf.values()))
        out = {k: v for k, v in d.items() if k != "layers"}
        for i in range(leaf.shape[0]):
            out[f"layer_{i}"] = _map_leaves(lambda x, i=i: x[i], stacked)
        return out

    return _map_dicts(fn, tree)


def has_stacked_trunks(tree) -> bool:
    """True when the tree stores pipeline-resident ``layers`` subtrees."""
    found = []

    def fn(d):
        if "layers" in d and isinstance(d["layers"], dict):
            found.append(True)
        return d

    _map_dicts(fn, tree)
    return bool(found)


# ---------------------------------------------------------------------- #
# dropout draws of a pipelined trunk
# ---------------------------------------------------------------------- #

class _Recording:
    """Records the draws a layer asks for (the shape past the batch axis
    and the tp-split dim) and keeps every element."""

    def __init__(self):
        self.calls: List[Tuple[tuple, Optional[int]]] = []

    def uniform(self, shape, device, tp_split=None):
        self.calls.append((tuple(shape[1:]), tp_split))
        return torch.ones(shape, device=device)


class _MicrobatchDraws:
    """One layer's draws for one microbatch: call k returns rows
    ``[j * m, (j + 1) * m)`` of the layer's k-th whole-batch draw.  Its
    state is the call count, so ``remat_layer`` can replay it."""

    def __init__(self, draws: List[torch.Tensor], rows: slice):
        self.draws, self.rows = draws, rows
        self.k = 0

    def uniform(self, shape, device, tp_split=None):
        u = self.draws[self.k][self.rows]
        if tuple(u.shape) != tuple(shape):
            raise RuntimeError(f"pipelined dropout draw {self.k} has shape "
                               f"{tuple(u.shape)}, the layer asked for "
                               f"{tuple(shape)}")
        self.k += 1
        return u

    def get_state(self):
        return self.k

    def set_state(self, k) -> None:
        self.k = k

    def fresh(self) -> "_MicrobatchDraws":
        return _MicrobatchDraws(self.draws, self.rows)


class StageDraws:
    """Each trunk layer's dropout draws as the sequential trunk makes them.

    The sequential trunk draws layer 0's masks over this rank's whole
    batch block (``uniform`` of ``generator``: a ``GlobalDraws`` draws the
    global shape), then layer 1's, and so on.  Every stage here draws them
    all in that order (one layer's sequence of draw shapes, the same for
    every layer of a homogeneous trunk, is read once by running a layer on
    one row with a recording generator) and keeps its own layers', so the
    generator leaves the trunk where the sequential trunk leaves it and
    ``for_layer(i, j)`` serves microbatch j of layer i its rows."""

    def __init__(self, generator, n_layers: int, owned: Sequence[int],
                 probe: Callable[[Any], None], rows: int, n_micro: int,
                 device):
        rec = _Recording()
        with torch.no_grad():
            probe(rec)
        self.m = rows // n_micro
        self.layers = {}
        for i in range(n_layers):
            draws = [uniform((rows,) + tail, generator, device, split)
                     for tail, split in rec.calls]
            if i in owned:
                self.layers[i] = draws

    def for_layer(self, i: int, j: int) -> _MicrobatchDraws:
        return _MicrobatchDraws(self.layers[i],
                                slice(j * self.m, (j + 1) * self.m))


# ---------------------------------------------------------------------- #
# the schedule
# ---------------------------------------------------------------------- #

def gpipe(stage_fn: Callable[[Tuple[torch.Tensor, ...], int],
                             Tuple[torch.Tensor, ...]],
          microbatches: Sequence[torch.Tensor], mesh) -> torch.Tensor:
    """Run ``microbatches`` through the trunk pipelined over ``mesh``'s pp
    axis; returns the first member of each finished microbatch, stacked
    ``(n_micro, ...)``, on every stage.

    ``stage_fn(act, j)`` applies this stage's layers to ``act`` (a tuple:
    the activation, then its riding inputs, e.g. the mask, which pass
    through unchanged) for microbatch ``j``; ``microbatches`` holds each
    member with a leading microbatch axis.  svpc_tpu's schedule: ``n +
    pp - 1`` ticks; stage 0 ingests microbatch ``min(t, n - 1)``, the
    last stage emits microbatch ``t - (pp - 1)`` under the emit gate, and
    the activation with its riding inputs moves one stage on after every
    tick (``ppermute``).  The last stage's buffer reaches every stage at
    the end (``trunk_exit``)."""
    pp, stage, group = mesh.pp_size, mesh.pp_index, mesh.pp_group
    n = microbatches[0].shape[0]
    device = microbatches[0].device
    first = torch.tensor(stage == 0, device=device)
    last = torch.tensor(stage == pp - 1, device=device)
    act = tuple(torch.zeros_like(m[0]) for m in microbatches)
    outs = [torch.zeros_like(microbatches[0][0]) for _ in range(n)]
    ticks = n + pp - 1
    for t in range(ticks):
        i_in = min(t, n - 1)
        act = tuple(torch.where(first, m[i_in], a)
                    for m, a in zip(microbatches, act))
        # stage s works on microbatch t - s; a bubble repeats a real index
        y = stage_fn(act, min(max(t - stage, 0), n - 1))
        if t >= pp - 1:
            i_out = t - (pp - 1)
            outs[i_out] = torch.where(last, y[0], outs[i_out])
        if t < ticks - 1:
            act = tuple(ppermute(a, group) for a in y)
    return trunk_exit(torch.stack(outs), last, group)

"""Greedy autoregressive decoding: the port of svpc_tpu/decode/greedy.py.

Reference: translator.py:45-163.  The semantics are the reference's: UNK
suppressed with -1e10, copy-produced OOV ids tracked in a parallel
extended-id buffer and fed back as UNK, position 0 forced to [BOS].  The
``lax.scan`` of the JAX package is a Python loop over positions here.

On the card the cached loop (the cache init, the cross-attention K/V
projection, the T-1 cached steps with their argmax, the last write) runs
as one CUDA graph per shape key (``DecodeGraphs``), captured the first
time a key is seen and replayed for every later batch of it: a step is
about 220 small kernels, which the eager loop launches one by one from the
host.  The encode stays eager (its shapes follow the batch's frame
count).  The graph engages on a CUDA device, with the KV cache, on a
model without a tp or pp mesh (their steps hold collectives); everything
else runs the eager loop.  A replay runs the eager loop's kernels on the
same shapes, so it gives the same tokens.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from svpc_torch import tokenization as tok
from svpc_torch.model.layers import Linear
from svpc_torch.model.svpc import EncodedState, clip_view, scatter_clips
from svpc_torch.ops.attention import LAUNCHES

NEG = -1e10

# the batch tensors the LM head and the pointer read (not in video mode)
HEAD_KEYS = ("entity_mask", "copy_ids", "copy_weights", "oov_count")
# decodes since the last reset_graphs(): graphs captured (that decode's
# tokens come from the eager warm-up run before the capture), graphs
# replayed, and decodes that took the eager loop
GRAPHS = {"captured": 0, "replayed": 0, "eager": 0}
_last = threading.local()


def reset_graphs() -> None:
    for name in GRAPHS:
        GRAPHS[name] = 0


def replayed_last() -> bool:
    """Whether this thread's last ``greedy_decode`` replayed a graph."""
    return getattr(_last, "replayed", False)


@torch.no_grad()
def greedy_decode(model, batch: Dict[str, torch.Tensor],
                  use_cache: bool = True, graph: bool = True) -> torch.Tensor:
    """Extended token ids (B, S, T) on the batch's device: [BOS], then the
    argmax tokens (plain ids in video mode).  The result is a new tensor
    (never a graph's buffer).

    ``use_cache=True`` decodes incrementally with per-layer KV caches
    (O(T)); ``False`` re-runs the decoder over all positions for every
    token, as the reference does.  Both give the same tokens.
    ``graph=False`` keeps the cached loop eager where it would replay a
    graph (tests and chip_smoke.py compare the two)."""
    cfg = model.cfg
    packed = "clip_video" in batch
    if packed:  # pseudo-batch of packed clips: batch axis N, one step
        grid = (batch["clip_input_ids"].shape[0], 1)
        head_batch = clip_view(batch)
    else:
        grid = tuple(batch["input_ids"].shape[:2])
        head_batch = batch

    state = model.encode(batch, deterministic=True)

    _last.replayed = False
    if graph and use_cache and graph_eligible(model,
                                              batch["step_mask"].device):
        graphs = decode_graphs(model)
        with graphs.lock:  # the graph's buffers are read until `out` is made
            (text_ids, ext_ids), _last.replayed = graphs.run(
                model, loop_inputs(model, state, head_batch), grid)
            out = _result(cfg, batch, text_ids, ext_ids, packed)
            return out if packed else out.clone()
    GRAPHS["eager"] += 1
    text_ids, ext_ids = _decode_loop(model, state, head_batch, grid,
                                     use_cache)
    return _result(cfg, batch, text_ids, ext_ids, packed)


def _result(cfg, batch, text_ids, ext_ids, packed: bool) -> torch.Tensor:
    out = text_ids if cfg.model_mode == "video" else ext_ids
    if packed:  # the (N, 1, T) clip rows back onto the (B, S, T) grid
        out = scatter_clips(batch, out[:, 0], tuple(batch["step_mask"].shape))
    return out


def _decode_loop(model, state: EncodedState, head_batch,
                 grid: Tuple[int, int], use_cache: bool):
    """The T-1 scoring iterations and the last write -> (text_ids,
    ext_ids), each (B, S, T).  Reads ``state.ga_inputs``,
    ``state.pointer_vectors`` and ``head_batch[HEAD_KEYS]``, and syncs
    nothing with the host."""
    cfg = model.cfg
    T, V, C = cfg.max_t_len, cfg.vocab_size, cfg.extended_vocab_size
    B, S = grid
    dev = state.ga_inputs.device

    cols = torch.arange(C, device=dev)
    if cfg.model_mode == "video":
        ext = torch.full((B,), V, dtype=torch.long, device=dev)
    else:
        ext = V + head_batch["oov_count"]
    col_ok = (cols[None, :] < ext[:, None]) & (cols[None, :] != tok.UNK)
    col_ok = col_ok[:, None, :]                              # (B, 1, C)

    text_ids = torch.zeros(B, S, T, dtype=torch.long, device=dev)  # [PAD]
    ext_ids = torch.zeros_like(text_ids)
    text_mask = torch.zeros(B, S, T, device=dev)
    next_sym = torch.full((B, S), tok.BOS, dtype=torch.long, device=dev)
    oov_next = next_sym.clone()

    def argmax_step(cur):
        # torch.argmax, like jnp.argmax, returns the first maximum
        nw = torch.argmax(cur.masked_fill(~col_ok, NEG), dim=-1)
        return torch.where(nw >= V, torch.full_like(nw, tok.UNK), nw), nw

    # T-1 scoring iterations: iteration t writes position t, then selects
    # the token for position t+1; the last one is written after the loop
    if use_cache:
        caches, enc_kv = model.init_decode_caches((B, S), state)
    for t in range(T - 1):
        text_ids[:, :, t] = next_sym
        ext_ids[:, :, t] = oov_next
        if use_cache:
            cur, caches = model.score_position_cached(
                head_batch, state, next_sym, t, caches, enc_kv)
        else:
            text_mask[:, :, t] = 1.0
            cur = model.score_position(head_batch, state, text_ids,
                                       text_mask, t)
        next_sym, oov_next = argmax_step(cur)
    text_ids[:, :, T - 1] = next_sym
    ext_ids[:, :, T - 1] = oov_next
    return text_ids, ext_ids


# ---------------------------------------------------------------------- #
# the cached loop as a CUDA graph
# ---------------------------------------------------------------------- #

def graph_eligible(model, device: torch.device) -> bool:
    """A graph replaces the cached loop on a CUDA device, for a model
    without a tp or pp mesh (a dp-only mesh decodes its block alone)."""
    mesh = getattr(model, "mesh", None)
    return device.type == "cuda" and (
        mesh is None or (mesh.tp_size == 1 and mesh.pp_size == 1))


def loop_inputs(model, state: EncodedState,
                head_batch) -> Dict[str, torch.Tensor]:
    """The tensors the cached loop reads, by name."""
    inputs = {"ga_inputs": state.ga_inputs}
    if model.cfg.model_mode != "video":
        inputs["pointer_vectors"] = state.pointer_vectors
        inputs.update((k, head_batch[k]) for k in HEAD_KEYS)
    return inputs


def _weights(model) -> tuple:
    """Where the model's parameters and buffers lie: a graph reads them
    there."""
    return tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                       model.buffers()))


def graph_key(model, inputs: Dict[str, torch.Tensor]) -> tuple:
    """What a captured graph is valid for: the loop inputs' shapes, dtypes
    and device, the compute dtype, the model mode and train flag, and the
    storage of every parameter and buffer.  A load in place keeps the key
    (the graph reads the new values where the old ones were); a parameter
    replaced by a new tensor changes it."""
    cfg = model.cfg
    return (tuple((k, tuple(t.shape), t.dtype, str(t.device))
                  for k, t in inputs.items()),
            str(model.compute_dtype), cfg.model_mode, model.training,
            _weights(model))


def decode_graphs(model) -> "DecodeGraphs":
    """The model's graph cache, made on first use."""
    graphs = getattr(model, "_decode_graphs", None)
    if graphs is None:
        graphs = model._decode_graphs = DecodeGraphs()
    return graphs


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]   # static input buffers, by name
    outputs: Tuple[torch.Tensor, torch.Tensor]  # (text_ids, ext_ids)
    launches: Dict[str, int]          # ops.attention.LAUNCHES of a replay


class DecodeGraphs:
    """One model's captured decode loops by ``graph_key``.  Every key is
    kept until the model's parameters move, then all are dropped: the
    callers decode at the few shapes they declare (a service's clip
    buckets, an eval dataset's one packed shape), so a declared shape is
    never captured twice.  The graphs share one memory pool: they replay
    one at a time, on the caller's stream, under ``lock``.  A copy
    (deepcopy, pickle) starts empty."""

    def __init__(self):
        self.lock = threading.Lock()
        self.entries: Dict[tuple, _Graph] = {}
        self.weights = None
        self.pool = None

    def __reduce__(self):
        return DecodeGraphs, ()

    def run(self, model, inputs: Dict[str, torch.Tensor],
            grid: Tuple[int, int]):
        """-> ((text_ids, ext_ids), replayed): a replay of the key's graph
        on ``inputs`` (its buffers: read them before the next run), or on
        a new key the eager warm-up's tokens, the graph captured after
        it."""
        key = graph_key(model, inputs)
        entry = self.lookup(key)
        if entry is None:
            return self._capture(model, inputs, grid, key), False
        for name, t in inputs.items():
            entry.inputs[name].copy_(t)
        entry.graph.replay()
        for name, n in entry.launches.items():
            LAUNCHES[name] += n
        GRAPHS["replayed"] += 1
        return entry.outputs, True

    def lookup(self, key: tuple) -> Optional[_Graph]:
        """The key's graph, or None; every graph (and their pool) is
        dropped first where the key's weights lie elsewhere."""
        if key[-1] != self.weights:
            self.entries.clear()
            self.weights, self.pool = key[-1], None
        return self.entries.get(key)

    def _capture(self, model, inputs, grid, key):
        static = {name: t.clone() for name, t in inputs.items()}
        # EncodedState fields the loop does not read stay None, so that a
        # capture that read one would fail rather than bake in the address
        # of a tensor freed after this batch
        state = EncodedState(step_vectors=None, ingr_vectors=None,
                             ga_inputs=static["ga_inputs"],
                             pointer_vectors=static.get("pointer_vectors"),
                             reasoner=None)

        def loop():
            return _decode_loop(model, state, static, grid, True)

        device = static["ga_inputs"].device
        # warm-up on a side stream: lazy set-up (kernel builds, library
        # handles) stays out of the capture; its tokens are this batch's
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            tokens = loop()
        torch.cuda.current_stream(device).wait_stream(side)

        before = dict(LAUNCHES)
        # an eval-mode Linear keeps its bf16 weights cast once (keyed by
        # the weights' version); casts made inside the capture replay with
        # the graph, so an in-place load reaches the graph too
        casts = _drop_casts(model)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                outputs = loop()
        finally:
            _restore_casts(casts)
            # a capture launches nothing; a replay launches what it recorded
            launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            LAUNCHES.update(before)
        self.entries[key] = _Graph(graph, static, outputs,
                                   {k: n for k, n in launches.items() if n})
        GRAPHS["captured"] += 1
        return tokens


def _drop_casts(model) -> list:
    """Empty every ``Linear``'s cast-weight cache; -> what they held."""
    held = [(m, m._cast) for m in model.modules() if isinstance(m, Linear)]
    for m, _ in held:
        m._cast = None
    return held


def _restore_casts(held: list) -> None:
    for m, cast in held:
        m._cast = cast

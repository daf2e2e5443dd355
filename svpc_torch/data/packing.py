"""Clip packing: drop padded step slots before they reach the device.

The reference pads every video to the batch-max step count and runs the
model over the padded grid (recursive_caption_dataset.py:557-576); the
dense layout likewise computes all ``B x S`` clip slots even though the
mean YC2 video has 7.7 real steps of the 12 padded.  The per-clip work —
the clip encoder, the decoder, the LM head + copy machinery — is
independent across clips, so a batch can instead carry a *packed* axis of
only the real clips:

  clip_video (N,) int32   owner video index b
  clip_step  (N,) int32   step index s within the owner
  clip_mask  (N,) float32 1 for real clip slots, 0 for padding
  clip_input_ids / clip_input_mask / clip_input_labels /
  clip_token_type_ids   (N, L)
  clip_video_feature    (N, Lv, D)

Per-video arrays (ingredients, entity/action supervision, step_mask) stay
at (B, ...).  The model scatters per-clip [CLS] summaries onto the (B, S)
step grid for the step-level recurrence and gathers the cross-attention
memory back per clip (model/svpc.py).  The video token span can also be
sliced to the batch max valid length rounded up to a bucket.

The port's copy of svpc_tpu/data/packing.py (same layout, same numbers),
with ``repad_packed`` / ``stack_batches`` for the K-steps-per-call train
step, and ``pack_examples(only_shards=...)`` for the trainer's per-rank
sharded data (parallel/mesh.py).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from svpc_torch import tokenization as tok

Batch = Dict[str, np.ndarray]

# dense per-clip arrays replaced by packed ones
_CLIP_KEYS = ("input_ids", "input_mask", "input_labels", "token_type_ids",
              "video_feature")


def round_up(n: int, multiple: int, cap: Optional[int] = None) -> int:
    r = max(multiple, ((n + multiple - 1) // multiple) * multiple)
    return min(r, cap) if cap is not None else r


_round_up = round_up  # internal alias


def shard_clip_counts(steps, batch_size: int, dp_shards: int):
    """Real clips per dp shard for a batch of per-example step counts —
    THE shard-assignment formula (example b -> shard b // (B/dp)); used
    by pack_examples' budget check and by serving's bucket picker so the
    two can never drift."""
    Bs = batch_size // dp_shards
    return [sum(steps[g * Bs:(g + 1) * Bs]) for g in range(dp_shards)]


def pack_batch(batch: Batch, max_t_len: int,
               n_clips: Optional[int] = None,
               v_len: Optional[int] = None,
               clip_multiple: int = 16,
               v_multiple: int = 16,
               dp_shards: int = 1) -> Batch:
    """Dense (B, S, ...) batch -> packed per-clip layout.

    ``n_clips`` / ``v_len`` pin the padded clip count (per shard) / video
    span; when None they are derived from the batch and rounded up to the
    given multiples (static-shape buckets).

    ``dp_shards > 1`` packs each contiguous B/dp video group separately
    (same per-shard clip count, global video indices), so the packed clip
    axis shards along the data-parallel mesh axis with every clip placed
    on the shard that owns its video's per-video arrays.
    """
    step_mask = batch["step_mask"]
    B, S = step_mask.shape
    L = batch["input_ids"].shape[-1]
    Lv = L - max_t_len
    if B % dp_shards:
        raise ValueError(f"batch {B} not divisible by dp_shards={dp_shards}")
    Bs = B // dp_shards

    groups = []  # (b_idx, s_idx) per shard, global video indices
    for g in range(dp_shards):
        gm = np.zeros_like(step_mask)
        gm[g * Bs:(g + 1) * Bs] = step_mask[g * Bs:(g + 1) * Bs]
        groups.append(np.nonzero(gm > 0))
    n_max = max(len(b) for b, _ in groups)
    N = n_clips or _round_up(n_max, clip_multiple)
    if n_max > N:
        raise ValueError(f"shard has {n_max} real clips > n_clips={N}")

    # batch-max valid video length (+2 for [CLS]/[SEP]) -> bucketed span
    b_all, s_all = np.nonzero(step_mask > 0)
    valid = (int(batch["input_mask"][b_all, s_all, :Lv].sum(axis=-1).max())
             if len(b_all) else 2)
    if v_len is None:
        v_len = _round_up(valid, v_multiple, cap=Lv)
    elif v_len < valid:
        raise ValueError(
            f"v_len={v_len} < batch max valid video span {valid}")
    if not (0 < v_len <= Lv):
        raise ValueError(f"v_len={v_len} outside (0, {Lv}]")

    out = {k: v for k, v in batch.items() if k not in _CLIP_KEYS}
    total = N * dp_shards
    out["clip_video"] = np.zeros((total,), np.int32)
    out["clip_step"] = np.zeros((total,), np.int32)
    out["clip_mask"] = np.zeros((total,), np.float32)
    clip_arrays = {}
    for k in ("input_ids", "input_mask", "token_type_ids", "input_labels"):
        fill = tok.IGNORE if k == "input_labels" else 0
        clip_arrays[k] = np.full((total, v_len + max_t_len), fill,
                                 batch[k].dtype)
    clip_arrays["video_feature"] = np.zeros(
        (total, v_len) + batch["video_feature"].shape[3:],
        batch["video_feature"].dtype)

    for g, (b_idx, s_idx) in enumerate(groups):
        n = len(b_idx)
        lo = g * N
        out["clip_video"][lo:lo + n] = b_idx
        out["clip_step"][lo:lo + n] = s_idx
        out["clip_mask"][lo:lo + n] = 1.0
        for k in ("input_ids", "input_mask", "token_type_ids",
                  "input_labels"):
            src = batch[k][b_idx, s_idx]  # (n, L)
            clip_arrays[k][lo:lo + n] = np.concatenate(
                [src[:, :v_len], src[:, Lv:]], axis=-1)
        clip_arrays["video_feature"][lo:lo + n] = \
            batch["video_feature"][b_idx, s_idx, :v_len]

    for k, v in clip_arrays.items():
        out[f"clip_{k}"] = v
    return out


def pack_examples(examples, max_t_len: int, batch_size: Optional[int] = None,
                  n_clips: Optional[int] = None,
                  v_len: Optional[int] = None,
                  clip_multiple: int = 16,
                  v_multiple: int = 16,
                  dp_shards: int = 1,
                  fill_workers: int = 0,
                  only_shards=None) -> Batch:
    """Examples -> packed batch directly, skipping the dense (B, S, ...)
    intermediate: per-video arrays stack (small), per-clip rows copy
    straight from each example into the final buffers.  Geometry and
    semantics are identical to pack_batch.  ``fill_workers > 1`` fills the
    videos' features on that many threads (the native fill releases the
    GIL).

    ``only_shards`` (dp-shard indices) builds only those shards' blocks,
    the per-video rows, clip rows and feature fills; the rest stays
    zero / fill-valued.  The shape (N, v_len) still comes from every
    example's token arrays (no features), so every rank derives the same
    global shape, and an owned block is byte-equal to the same block of
    the full build (``--multihost_sharded_data``, parallel/mesh.py)."""
    B = batch_size or len(examples)
    if B % dp_shards:
        raise ValueError(f"batch {B} not divisible by dp_shards={dp_shards}")
    Bs = B // dp_shards
    owned = frozenset(only_shards) if only_shards is not None else None
    first = examples[0].arrays
    L = first["input_ids"].shape[-1]
    Lv = L - max_t_len

    steps = [int(e.arrays["step_mask"].sum()) for e in examples]
    n_max = (max(shard_clip_counts(steps, B, dp_shards))
             if examples else 0)
    N = n_clips or _round_up(n_max, clip_multiple)
    if n_max > N:
        raise ValueError(f"shard has {n_max} real clips > n_clips={N}")

    valid = 2
    for e, n in zip(examples, steps):
        if n:
            valid = max(valid, int(
                e.arrays["input_mask"][:n, :Lv].sum(axis=-1).max()))
    if v_len is None:
        v_len = _round_up(int(valid), v_multiple, cap=Lv)
    elif v_len < valid:
        # an explicit span bucket smaller than the batch's longest clip
        # would silently truncate — always an error
        raise ValueError(
            f"v_len={v_len} < batch max valid video span {valid}")
    if not (0 < v_len <= Lv):
        raise ValueError(f"v_len={v_len} outside (0, {Lv}]")

    # per-video arrays: stacked with zero/IGNORE padding to B
    from svpc_torch.data.pipeline import ARRAY_KEYS, fill_features_from_ref
    lazy = "video_feature" not in first
    out: Batch = {}
    for k in ARRAY_KEYS:
        if k in _CLIP_KEYS:
            continue
        proto = first[k]
        dst = np.zeros((B,) + proto.shape, proto.dtype)
        for b, e in enumerate(examples):
            if owned is not None and b // Bs not in owned:
                continue
            dst[b] = e.arrays[k]
        out[k] = dst

    total = N * dp_shards
    out["clip_video"] = np.zeros((total,), np.int32)
    out["clip_step"] = np.zeros((total,), np.int32)
    out["clip_mask"] = np.zeros((total,), np.float32)
    clip_arrays = {}
    for k in ("input_ids", "input_mask", "token_type_ids", "input_labels"):
        fill = tok.IGNORE if k == "input_labels" else 0
        clip_arrays[k] = np.full((total, v_len + max_t_len), fill,
                                 first[k].dtype)
    feat_shape = ((examples[0].meta["feature_ref"]["feature_size"],)
                  if lazy else first["video_feature"].shape[2:])
    clip_arrays["video_feature"] = np.zeros((total, v_len) + feat_shape,
                                            np.float32)

    fill_jobs = []
    for b, (e, n) in enumerate(zip(examples, steps)):
        if not n:
            continue
        g = b // Bs
        if owned is not None and g not in owned:
            continue
        lo = g * N + sum(steps[g * Bs:b])
        out["clip_video"][lo:lo + n] = b
        out["clip_step"][lo:lo + n] = np.arange(n)
        out["clip_mask"][lo:lo + n] = 1.0
        arrs = e.arrays
        for k in ("input_ids", "input_mask", "token_type_ids",
                  "input_labels"):
            clip_arrays[k][lo:lo + n, :v_len] = arrs[k][:n, :v_len]
            clip_arrays[k][lo:lo + n, v_len:] = arrs[k][:n, Lv:]
        if lazy:
            # the lazy pipeline's one feature copy: straight into the
            # packed batch buffer (native packer: mmap -> buffer)
            ref = e.meta["feature_ref"]
            if int(ref["valid"].max(initial=0)) + 2 > v_len:
                raise ValueError(  # hard bound: the native fill writes
                    f"{ref['name']}: clip span exceeds v_len={v_len}")
            fill_jobs.append((ref, clip_arrays["video_feature"][lo:lo + n]))
        else:
            clip_arrays["video_feature"][lo:lo + n] = \
                arrs["video_feature"][:n, :v_len]

    if fill_workers > 1 and len(fill_jobs) > 1:
        # the native fill releases the GIL (ctypes), so threads give real
        # parallelism on multi-core hosts
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(fill_workers) as pool:
            list(pool.map(lambda j: fill_features_from_ref(*j), fill_jobs))
    else:
        for job in fill_jobs:
            fill_features_from_ref(*job)

    for k, v in clip_arrays.items():
        out[f"clip_{k}"] = v
    return out


def is_packed(batch) -> bool:
    return "clip_video" in batch


def repad_packed(batch: Batch, max_t_len: int, n_clips: int, v_len: int,
                 dp_shards: int = 1) -> Batch:
    """Grow a packed batch to a larger (per-shard n_clips, v_len) geometry.

    Produces exactly what pack_batch would have built with the bigger
    budgets: extra clip rows are padding (clip_mask 0, labels IGNORE) and
    the video span is zero-extended between the valid rows and the text
    columns.  Gives a group of differently-bucketed batches one shared
    shape so they stack (``stack_batches``).  No-op (no copy) when the
    shape already matches.

    ``dp_shards`` must match the value the batch was packed with: padding
    is inserted inside each contiguous per-shard clip group.
    """
    total_old = batch["clip_mask"].shape[0]
    if total_old % dp_shards:
        raise ValueError(
            f"packed clip axis {total_old} not divisible by "
            f"dp_shards={dp_shards}")
    N_old = total_old // dp_shards
    v_old = batch["clip_input_ids"].shape[-1] - max_t_len
    if n_clips < N_old or v_len < v_old:
        raise ValueError(
            f"repad_packed only grows: ({N_old},{v_old}) -> "
            f"({n_clips},{v_len})")
    if n_clips == N_old and v_len == v_old:
        return batch

    out = {k: v for k, v in batch.items() if not k.startswith("clip_")}
    total = n_clips * dp_shards
    for k in ("clip_video", "clip_step", "clip_mask"):
        dst = np.zeros((total,), batch[k].dtype)
        for g in range(dp_shards):
            dst[g * n_clips:g * n_clips + N_old] = \
                batch[k][g * N_old:(g + 1) * N_old]
        out[k] = dst
    for k in ("clip_input_ids", "clip_input_mask", "clip_token_type_ids",
              "clip_input_labels"):
        fill = tok.IGNORE if k == "clip_input_labels" else 0
        dst = np.full((total, v_len + max_t_len), fill, batch[k].dtype)
        for g in range(dp_shards):
            src = batch[k][g * N_old:(g + 1) * N_old]
            dst[g * n_clips:g * n_clips + N_old, :v_old] = src[:, :v_old]
            dst[g * n_clips:g * n_clips + N_old, v_len:] = src[:, v_old:]
        out[k] = dst
    feat = batch["clip_video_feature"]
    dst = np.zeros((total, v_len) + feat.shape[2:], feat.dtype)
    for g in range(dp_shards):
        dst[g * n_clips:g * n_clips + N_old, :v_old] = \
            feat[g * N_old:(g + 1) * N_old]
    out["clip_video_feature"] = dst
    return out


def stack_batches(batches, max_t_len: int, dp_shards: int = 1) -> Batch:
    """Stack K same-batch-size batches along a new leading axis (K, ...)
    for ``train.step.multi_train_step``: one pinned copy carries K
    optimizer steps.  Packed batches are first repadded to the group-max
    (n_clips, v_len), a host copy skipped when the group already shares
    one bucket (length-grouped shuffling makes that the common case)."""
    if len(batches) == 1:
        return {k: v[None] for k, v in batches[0].items()}
    if is_packed(batches[0]):
        n = max(b["clip_mask"].shape[0] for b in batches) // dp_shards
        v = max(b["clip_input_ids"].shape[-1] for b in batches) - max_t_len
        batches = [repad_packed(b, max_t_len, n, v, dp_shards)
                   for b in batches]
    return {k: np.stack([b[k] for b in batches])
            for k in batches[0]}


def fixed_clip_budget(dataset, batch_size: int, multiple: int = 16,
                      dp_shards: int = 1) -> int:
    """Max real-clip count (per dp shard) over the dataset's deterministic
    (unshuffled) batch partition, rounded up to ``multiple``: every eval
    batch then has ONE packed shape."""
    counts = [min(len(e["sentences"]), dataset.num_steps)
              for e in dataset.data]
    if not counts:
        return multiple
    group = max(1, batch_size // dp_shards)
    sums = []
    for i in range(0, len(counts), batch_size):
        window = counts[i:i + batch_size]
        sums.extend(sum(window[j:j + group])
                    for j in range(0, len(window), group))
    return _round_up(max(sums), multiple)

"""Online serving: a fixed-geometry decode service + dynamic request batching.

The port of svpc_tpu/serving.py for videos whose features are on disk or
uploaded with the request (``upload_dir``), decoded greedily or by beam
search (``beam_size > 1``, with ``n_best``
ranked hypotheses per clip).  ``CaptionService`` pins one serving geometry —
``batch_videos`` video slots x ``max_clips`` steps x ``max_v_len`` feature
rows, the packed clip budget rounded to the pack multiple — so every
request batch has the same shapes (and the same kernel launches).
``DynamicBatcher`` coalesces concurrent requests into one device batch (up
to ``batch_videos`` videos or ``max_wait_ms``).  Host work (tokenization,
feature fill) runs in the submitting thread; the one batcher thread only
assembles batches and runs the model.

On a dp x tp ``mesh`` (parallel/mesh.py, one process a rank, as
svpc_tpu's ``CaptionService(mesh=...)`` is one process over many devices)
every rank holds its tp shards of the model and decodes its dp block of
each batch; the tokens are gathered to every rank.  Rank 0 runs the HTTP
front and the ``DynamicBatcher``; for each batch it broadcasts the
examples' entries (the request specs, not the features) and every rank
builds its own block of the batch with the native packer.  The other
ranks ``follow()`` those messages until rank 0's ``close()`` sends them
the end (and, while idle, a heartbeat, so an idle follower never reaches
the process group's timeout).  Uploaded features are written by rank 0
into the spool and read from disk by every rank.  A failure once rank 0
has announced a batch (a follower's fill, a collective, the decode)
leaves the ranks out of step: a follower raises out of ``follow()``, and
rank 0 fails that batch and sets ``broken``, after which the service
takes no batch and cli/serve.py shuts down with a non-zero exit.
The HTTP front-end lives in cli/serve.py.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from svpc_torch import tokenization as tok
from svpc_torch.config import Config
from svpc_torch.data.packing import pack_examples
from svpc_torch.data.packing import round_up as _round_up
from svpc_torch.data.packing import shard_clip_counts
from svpc_torch.data.pipeline import (CaptionDataset, Example, batch_examples,
                                      inference_entries, pad_batch_to)
from svpc_torch.decode.beam import beam_decode
from svpc_torch.decode.greedy import greedy_decode, replayed_last
from svpc_torch.decode.postprocess import batch_to_sentences, nbest_entries
from svpc_torch.model.svpc import to_tensors
from svpc_torch.parallel.collectives import gather_dim
from svpc_torch.parallel.mesh import rank_device, shard_batch
from svpc_torch.precision import check_compute_dtype, resolve_device

logger = logging.getLogger(__name__)


class ServingError(ValueError):
    """Client-side request problem (maps to HTTP 400)."""


class DecodeFailure(RuntimeError):
    """Device-side batch failure, already counted in the serving stats
    by the batcher worker (maps to HTTP 502, not re-counted)."""


class DecodeTimeout(TimeoutError):
    """submit() gave up waiting for the batched decode (already counted
    by the submitter; maps to HTTP 503)."""


# seconds between rank 0's messages to idle followers on a mesh
HEARTBEAT_S = 20.0


def dummy_example(cfg: Config, num_steps: int,
                  action_vocab_size: int) -> Example:
    """A zero-filled Example with exactly the shapes CaptionDataset.
    make_example produces at this geometry, used to warm the service.
    One clip slot is real so the packer lays out a row; its [CLS]/[SEP]
    mask mirrors a 0-frame clip."""
    m = cfg.model
    S, L = num_steps, m.max_v_len + m.max_t_len
    arrays = dict(
        input_ids=np.zeros((S, L), np.int32),
        input_mask=np.zeros((S, L), np.float32),
        input_labels=np.full((S, L), tok.IGNORE, np.int32),
        token_type_ids=np.zeros((S, L), np.int32),
        video_feature=np.zeros((S, m.max_v_len, m.video_feature_size),
                               np.float32),
        step_mask=np.zeros((S,), np.float32),
        ingr_ids=np.zeros((m.max_i_len,), np.int32),
        ingr_mask=np.zeros((m.max_i_len,), np.int32),
        ingr_sep_mask=np.zeros((m.max_i_len,), np.int32),
        entity_mask=np.zeros((m.max_entities,), np.float32),
        copy_ids=np.zeros((m.max_entities, m.max_ingr_words), np.int32),
        copy_weights=np.zeros((m.max_entities, m.max_ingr_words),
                              np.float32),
        oov_count=np.asarray(0, np.int32),
        alignment=np.zeros((S, m.max_entities), np.float32),
        action=np.zeros((S, action_vocab_size), np.float32),
        action_row_mask=np.zeros((S,), np.float32),
    )
    arrays["step_mask"][0] = 1.0
    arrays["input_ids"][0, 0] = tok.CLS
    arrays["input_ids"][0, 1] = tok.SEP
    arrays["input_mask"][0, :2] = 1.0
    meta = dict(name="__warmup__", timestamps=[[0.0, 0.0]],
                gt_sentences=[""], oov_word_dict={}, n_steps=1,
                n_entities=0)
    return Example(arrays=arrays, meta=meta)


class CaptionService:
    """Decode captions for user video specs at one fixed geometry.

    ``model`` is an SVPCModel holding the (whole) eval weights; the
    service cuts it to ``mesh``'s tp shards when given one and moves it to
    ``device`` (the card unless ``device="cpu"``; on a mesh each rank's,
    ``parallel.mesh.rank_device``).  The service owns a CaptionDataset
    shell (vocab, duration CSV, feature store)."""

    def __init__(self, cfg: Config, model,
                 batch_videos: int = 8,
                 max_clips: Optional[int] = None,
                 beam_size: int = 0,
                 n_best: int = 1,
                 feature_store=None,
                 mesh=None,
                 clip_buckets: Optional[Sequence[int]] = None,
                 upload_dir: Optional[str] = None,
                 warmup: bool = True,
                 device=None):
        if n_best < 1:
            raise ValueError(f"n_best must be >= 1, got {n_best}")
        if n_best > 1 and not (beam_size and beam_size > 1):
            raise ValueError(
                f"n_best={n_best} requires beam search (beam_size > 1); "
                "greedy decoding yields a single hypothesis")
        if n_best > max(beam_size, 1):
            raise ValueError(
                f"n_best={n_best} cannot exceed beam_size={beam_size}")
        if batch_videos < 1:
            raise ValueError(f"batch_videos must be >= 1, got {batch_videos}")
        # multi-card serving: request batches shard over dp, the model
        # over the tp rules (the layout cli.evaluate's mesh uses)
        self.mesh = mesh
        dp = mesh.dp_size if mesh is not None else 1
        if batch_videos % dp:
            raise ValueError(
                f"batch_videos={batch_videos} must be a multiple of the "
                f"dp mesh axis ({dp})")
        self._dp = dp
        # the features go to the card in the compute dtype (svpc_tpu/
        # serving.py:208, ``cast_transform``)
        self.feature_dtype = check_compute_dtype(cfg.model)
        max_clips = max_clips or cfg.model.max_n_sen
        cfg = cfg.replace_train(val_batch_size=batch_videos)
        self.cfg = cfg
        if mesh is not None:
            self.device = rank_device(device)
            model = model.shard(mesh)
        else:
            self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_videos = batch_videos
        self.beam_size = beam_size if beam_size and beam_size > 1 else 0
        self.n_best = n_best
        self.ds = CaptionDataset(cfg, "infer", num_steps=max_clips,
                                 entries=[], lazy_features=True,
                                 feature_store=feature_store)
        if self.ds.action_vocab_size != cfg.model.action_vocab_size:
            raise ValueError(
                f"verb vocab ({self.ds.action_vocab_size}) does not match "
                f"model action_vocab_size ({cfg.model.action_vocab_size})")

        # optional feature-upload spool: requests may carry the feature
        # arrays themselves (plus duration/n_frames for the frm2sec math)
        # instead of relying on files pre-staged under video_feature_dir
        self._upload_dir = upload_dir
        self._upload_lock = threading.Lock()
        self.up_ds: Optional[CaptionDataset] = None
        if upload_dir:
            from svpc_torch.data.features import FeatureStore
            os.makedirs(upload_dir, exist_ok=True)
            self.up_ds = CaptionDataset(
                cfg, "infer", num_steps=max_clips, entries=[],
                lazy_features=True, feature_store=FeatureStore(upload_dir))
            self.up_ds.frame_to_second = {}  # rows arrive per upload

        # packed clip budgets (per dp shard): the worst case (every slot
        # a full video) is always covered; smaller ``clip_buckets`` let
        # light batches (a lone request) ride a smaller shape
        mult = cfg.train.pack_clip_multiple
        budget = _round_up((batch_videos // dp) * max_clips, mult)
        dropped = [int(b) for b in (clip_buckets or [])
                   if not 0 < int(b) < budget]
        if dropped:
            logger.warning(
                "clip_buckets %s outside (0, worst-case budget %d) have "
                "no effect and were ignored", dropped, budget)
        self._buckets = sorted({_round_up(int(b), mult)
                                for b in (clip_buckets or [])
                                if 0 < int(b) < budget} | {budget})
        self._packed = cfg.train.pack_clips
        # one model on one device; the lock keeps direct multi-threaded
        # callers of decode_payloads / caption safe (and, on a mesh, rank
        # 0's broadcasts in the order of its decodes)
        self._lock = threading.Lock()
        self._last_message = time.monotonic()
        self._heartbeat: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self.broken = threading.Event()  # set when the mesh fell out of step
        if warmup:
            self.warmup()
        if mesh is not None and mesh.is_main:
            self._heartbeat = threading.Thread(
                target=self._beat, name="svpc-heartbeat", daemon=True)
            self._heartbeat.start()

    @property
    def max_clips(self) -> int:
        return self.ds.num_steps

    def build_batch(self, examples: Sequence[Example], n_clips: int = 0):
        """Examples -> the fixed-geometry numpy batch: packed with the
        smallest clip bucket covering them (or ``n_clips``), else dense."""
        examples = list(examples)
        if not self._packed:
            return pad_batch_to(batch_examples(examples), self.batch_videos)
        if not n_clips:
            steps = [int(e.arrays["step_mask"].sum()) for e in examples]
            shard_max = max(shard_clip_counts(steps, self.batch_videos,
                                              self._dp))
            n_clips = next(b for b in self._buckets if shard_max <= b)
        t = self.cfg.train
        # on a mesh each rank fills only its own dp block's features
        return pack_examples(
            examples, self.cfg.model.max_t_len, batch_size=self.batch_videos,
            n_clips=n_clips, v_len=self.cfg.model.max_v_len,
            clip_multiple=t.pack_clip_multiple, v_multiple=t.pack_v_multiple,
            dp_shards=self._dp,
            only_shards=(None if self.mesh is None
                         else {self.mesh.dp_index}))

    def warmup(self) -> None:
        """Run the decoder once per clip bucket on a zero batch, so the
        first real request pays no kernel build or allocator growth (on a
        mesh every rank warms up alike, as it builds the service)."""
        t0 = time.perf_counter()
        ex = dummy_example(self.cfg, self.max_clips,
                           self.ds.action_vocab_size)
        for n in (self._buckets if self._packed else [0]):
            self._decode_batch(self.build_batch([ex], n))
        logger.info("serving decoder ready in %.1fs on %s (B=%d videos x "
                    "S=%d clips, packed bucket(s) %s)",
                    time.perf_counter() - t0, self.device, self.batch_videos,
                    self.max_clips, self._buckets)

    # ---------------------------------------------------------------- #
    # request validation / host-side example building
    # ---------------------------------------------------------------- #

    def put_features(self, video_id: str, features: Dict,
                     duration, n_frames) -> None:
        """Spool uploaded feature arrays (base64 .npy payloads) and the
        video's frm2sec row so subsequent requests can decode it."""
        import base64
        import io

        from svpc_torch.data.anet import duration_to_frm2sec
        if self.up_ds is None:
            raise ServingError(
                "feature upload is disabled — start the daemon with "
                "--upload_dir")
        if not isinstance(features, dict) or \
                not {"resnet", "bn"} <= set(features):
            raise ServingError(
                "'features' must carry base64 .npy payloads under "
                "'resnet' and 'bn'")
        try:
            duration, n_frames = float(duration), float(n_frames)
        except (TypeError, ValueError):
            raise ServingError(
                "feature upload needs numeric 'duration' (seconds) and "
                "'n_frames' (the duration-CSV row for the frm2sec math)")
        if duration <= 0 or n_frames <= 0:
            raise ServingError("'duration' and 'n_frames' must be > 0")
        arrays = {}
        for kind in ("resnet", "bn"):
            try:
                arrays[kind] = np.load(
                    io.BytesIO(base64.b64decode(features[kind])),
                    allow_pickle=False)
            except Exception as e:
                raise ServingError(
                    f"features.{kind}: not a valid base64 .npy payload "
                    f"({e})")
        r, b = arrays["resnet"], arrays["bn"]
        want = self.cfg.model.video_feature_size
        if r.ndim != 2 or b.ndim != 2 or r.shape[0] != b.shape[0]:
            raise ServingError(
                f"feature arrays must be 2-D with equal rows; got "
                f"resnet{tuple(r.shape)} bn{tuple(b.shape)}")
        if r.shape[1] + b.shape[1] != want:
            raise ServingError(
                f"resnet+bn feature dims {r.shape[1]}+{b.shape[1]} != "
                f"model video_feature_size {want}")
        vn = self.up_ds.video_name(video_id)
        store = self.up_ds.store
        # the big work (casts, disk writes) happens OUTSIDE the lock under
        # collision-free tmp names, so concurrent uploads of unrelated
        # videos do not queue behind each other
        staged = []  # (tmp, final)
        for kind, arr in arrays.items():
            # float32 on disk whatever the client sent (float16 included):
            # the native packer's fast path, and the bytes the disk-staged
            # features of the same video give
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            # temp-write + atomic rename: a concurrent in-flight decode
            # holding the old file's mmap keeps reading the old inode
            # instead of seeing a truncated rewrite
            final = os.path.join(store.feature_dir, f"{vn}_{kind}.npy")
            tmp = (f"{final}.{os.getpid()}.{threading.get_ident()}"
                   ".tmp.npy")  # np.save keeps .npy-suffixed names
            np.save(tmp, arr)
            staged.append((tmp, final))
        with self._upload_lock:
            # only the publish step is serialized: the two renames of one
            # video land as a pair, so a racing RE-upload of the SAME id
            # cannot interleave into a mixed resnet/bn pair on disk (a
            # decode already holding the old mmaps is stopped by the
            # packer's row bound, not corrupted)
            for tmp, final in staged:
                os.replace(tmp, final)
            store.invalidate()  # re-uploads must drop cached rows/mmaps
            self.up_ds.frame_to_second[vn] = duration_to_frm2sec(
                duration, n_frames, self.cfg.data.dset_name,
                self.cfg.data.sampling_sec)

    def _owner(self, video_id: str) -> Optional[CaptionDataset]:
        """Dataset shell that can serve this video: uploads win (most
        recent information), then the configured feature dir."""
        if self.up_ds is not None:
            vn = self.up_ds.video_name(video_id)
            if self.up_ds.store.exists(vn) and \
                    vn in self.up_ds.frame_to_second:
                return self.up_ds
        vn = self.ds.video_name(video_id)
        if self.ds.store.exists(vn) and vn in self.ds.frame_to_second:
            return self.ds
        return None

    def make_entry(self, video_id: str, spec: Dict) -> dict:
        """Validate one request spec -> dataset entry.

        Raises ServingError with a client-usable message on bad input
        (unknown feature files, missing duration row, no timestamps).  A
        spec carrying 'features' (+ 'duration'/'n_frames') uploads the
        video's feature arrays first."""
        if not isinstance(video_id, str) or not video_id \
                or os.sep in video_id \
                or (os.altsep and os.altsep in video_id) \
                or ".." in video_id or video_id.startswith("."):
            # ids become <id>_{resnet,bn}.npy paths (and upload WRITES
            # them): reject anything that could escape the directory
            raise ServingError(f"invalid video_id {video_id!r}")
        if not isinstance(spec, dict) or "timestamps" not in spec:
            raise ServingError(
                "request must carry {'timestamps': [[start_s, end_s], ...],"
                " 'ingredients': [...]}")
        raw_ts = spec["timestamps"]
        if not isinstance(raw_ts, (list, tuple)) or not raw_ts:
            raise ServingError(f"{video_id}: needs at least one timestamp")
        ts = []
        for i, t in enumerate(raw_ts):
            try:
                if not isinstance(t, (list, tuple)) or len(t) != 2:
                    raise ValueError
                s, e = float(t[0]), float(t[1])
                if not (math.isfinite(s) and math.isfinite(e)
                        and 0 <= s <= e):
                    raise ValueError
            except (TypeError, ValueError):
                raise ServingError(
                    f"{video_id}: timestamp {i} must be a finite numeric "
                    f"[start_s, end_s] pair with 0 <= start <= end, "
                    f"got {t!r}")
            ts.append([s, e])
        if len(ts) > self.max_clips:
            logger.warning("%s: %d clips truncated to serving max_clips=%d",
                           video_id, len(ts), self.max_clips)
        if "features" in spec:
            self.put_features(video_id, spec["features"],
                              spec.get("duration"), spec.get("n_frames"))
        entry = inference_entries(
            {video_id: dict(timestamps=ts,
                            ingredients=list(spec.get("ingredients", [])),
                            sentences=spec.get("sentences"))},
            self.max_clips)[0]
        owner = self._owner(video_id)
        if owner is None:
            vn = self.ds.video_name(video_id)
            if not self.ds.store.exists(vn):
                raise ServingError(
                    f"{video_id}: no feature files (<vid>_resnet.npy + "
                    f"<vid>_bn.npy) under {self.ds.store.feature_dir}"
                    + (" — or upload them in the request ('features')"
                       if self.up_ds is not None else ""))
            raise ServingError(
                f"{video_id}: no duration row in "
                f"{self.cfg.data.duration_file}")
        entry["source"] = "upload" if owner is self.up_ds else "disk"
        if owner is self.up_ds:
            # the followers of a mesh read the spool with this row
            entry["frm2sec"] = self.up_ds.frame_to_second[
                self.up_ds.video_name(video_id)]
        return entry

    def example_for(self, entry: dict) -> Example:
        ds = self.up_ds if entry.get("source") == "upload" else self.ds
        ex = ds.make_example(entry)
        ex.meta["entry"] = entry
        return ex

    # ---------------------------------------------------------------- #
    # device batch decode
    # ---------------------------------------------------------------- #

    @property
    def decoder(self) -> str:
        """"greedy" or "beam{K}"."""
        return f"beam{self.beam_size}" if self.beam_size else "greedy"

    def _decode_batch(self, batch):
        """Decode one numpy batch -> host arrays: one (B, S, T) token grid,
        or the ``(tokens (B, n, S, T), scores (B, n, S))`` pair under
        n_best > 1.  On a mesh every rank calls it on the same batch (its
        own dp block filled): it decodes that block and gathers every
        block's outputs."""
        if self.mesh is not None:
            batch = shard_batch(self.mesh, batch)
        b = to_tensors(batch, self.device, self.feature_dtype)
        if not self.beam_size:
            out = greedy_decode(self.model, b)
        else:
            out = beam_decode(self.model, b, beam_size=self.beam_size,
                              n_best=self.n_best)
        outs = out if isinstance(out, tuple) else (out,)
        if self.mesh is not None:  # every dp block's rows, in batch order
            outs = tuple(gather_dim(t, 0, self.mesh.dp_group) for t in outs)
        outs = tuple(t.cpu().numpy() for t in outs)
        return outs if isinstance(out, tuple) else outs[0]

    # ---------------------------------------------------------------- #
    # mesh: rank 0 leads, the other ranks follow
    # ---------------------------------------------------------------- #

    def _announce(self, message) -> None:
        """Rank 0's message to every rank (under ``self._lock``)."""
        import torch.distributed as dist
        dist.broadcast_object_list([message], src=0)
        self._last_message = time.monotonic()

    def _beat(self) -> None:
        """Rank 0: a heartbeat to the followers while no batch is sent."""
        while not self._closed.wait(HEARTBEAT_S / 4):
            with self._lock:
                if self._closed.is_set() or self.broken.is_set():
                    return
                if time.monotonic() - self._last_message >= HEARTBEAT_S:
                    try:
                        self._announce("heartbeat")
                    except Exception as e:
                        self._mesh_failed(e)
                        return

    def _mesh_failed(self, error: Exception) -> None:
        """Rank 0: a message or a batch's collectives failed, so the
        ranks are out of step for good; no further batch is taken."""
        logger.error("the mesh failed (%r); the service takes no further "
                     "batch", error)
        self.broken.set()

    def _examples_from(self, entries) -> List[Example]:
        """A follower's examples of rank 0's entries (an uploaded video's
        frm2sec row comes with its entry; its files are on the spool)."""
        for e in entries:
            if e.get("source") == "upload":
                vn = self.up_ds.video_name(e["name"])
                self.up_ds.store.invalidate()
                self.up_ds.frame_to_second[vn] = e["frm2sec"]
        return [self.example_for(e) for e in entries]

    def follow(self) -> None:
        """A rank other than 0 on a mesh: decode each batch rank 0
        announces, with it, until ``close()`` ends the service.  Any
        failure (its block's fill included) propagates: the process exits,
        and rank 0's pending collective raises."""
        import torch.distributed as dist
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            if box[0] is None:
                return
            if box[0] == "heartbeat":
                continue
            self._decode_batch(self.build_batch(
                self._examples_from(box[0])))

    def close(self) -> None:
        """Rank 0 on a mesh: end the followers' ``follow()``."""
        if self.mesh is None or not self.mesh.is_main or \
                self._closed.is_set():
            return
        with self._lock:
            self._closed.set()
            if not self.broken.is_set():
                self._announce(None)

    def decode_payloads(self, examples: Sequence[Example]
                        ) -> List[List[dict]]:
        """Decode up to ``batch_videos`` examples -> per-example per-clip
        payload dicts: ``{"sentence": str}``, plus ``"nbest":
        [{"sentence", "score"}, ...]`` ranked best-first under n_best > 1,
        as the offline ``run_nbest_eval`` (train/loop.py) builds them.  On
        a mesh rank 0 calls it and the other ranks decode alongside
        (``follow``)."""
        if len(examples) > self.batch_videos:
            raise ValueError(
                f"{len(examples)} examples > batch_videos={self.batch_videos}")
        batch = self.build_batch(examples)
        with self._lock:
            if self.mesh is None:
                out = self._decode_batch(batch)
            else:
                if self._closed.is_set() or self.broken.is_set():
                    raise RuntimeError("the mesh service is closed or "
                                       "broken")
                try:
                    self._announce([e.meta["entry"] for e in examples])
                    out = self._decode_batch(batch)
                except Exception as e:
                    self._mesh_failed(e)
                    raise
        metas = [e.meta for e in examples]
        if self.n_best > 1:
            sentences, nbest = nbest_entries(*out, metas, self.ds.vocab)
            return [[dict({"sentence": s}, **extra)
                     for s, extra in zip(sents, extras)]
                    for sents, extras in zip(sentences, nbest)]
        sentences = batch_to_sentences(out, metas, self.ds.vocab)
        return [[{"sentence": s} for s in sents] for sents in sentences]

    def decode_examples(self, examples: Sequence[Example]) -> List[List[str]]:
        """Decode up to ``batch_videos`` examples -> per-example sentence
        lists (one postprocessed sentence per real clip; rank 0 under
        n_best)."""
        return [[c["sentence"] for c in clips]
                for clips in self.decode_payloads(examples)]

    def caption(self, specs: Dict[str, Dict]) -> Dict[str, List[dict]]:
        """Synchronous convenience: decode a whole spec dict (chunked to the
        serving batch size) -> {vid: [{timestamp, sentence}, ...]}."""
        entries = [self.make_entry(vid, spec) for vid, spec in specs.items()]
        out: Dict[str, List[dict]] = {}
        for lo in range(0, len(entries), self.batch_videos):
            chunk = entries[lo:lo + self.batch_videos]
            examples = [self.example_for(e) for e in chunk]
            for entry, clips in zip(chunk, self.decode_payloads(examples)):
                out[entry["name"]] = [
                    dict({"timestamp": entry["timestamps"][i]}, **c)
                    for i, c in enumerate(clips)]
        return out


class _Pending:
    __slots__ = ("example", "done", "result", "error", "t_submit",
                 "abandoned", "_acct_lock", "_accounted")

    def __init__(self, example: Example):
        self.example = example
        self.done = threading.Event()
        self.result: Optional[List[dict]] = None
        self.error: Optional[BaseException] = None
        self.t_submit = time.perf_counter()
        # set when the submitter gave up (timeout / closed batcher): the
        # worker drops it instead of wasting a batch slot on it
        self.abandoned = False
        self._acct_lock = threading.Lock()
        self._accounted = False

    def claim_accounting(self) -> bool:
        """Exactly-once stats ownership between the submitter's timeout
        path and the worker's batch bookkeeping."""
        with self._acct_lock:
            if self._accounted:
                return False
            self._accounted = True
            return True


class ServingStats:
    """Thread-safe serving counters + latency quantiles."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.batches = 0
        self.videos = 0
        self.clips = 0
        self.graph_batches = 0
        self._lat = collections.deque(maxlen=window)
        self._batch_s = collections.deque(maxlen=window)

    def record_batch(self, n_videos: int, n_clips: int,
                     latencies: Sequence[float],
                     batch_seconds: Optional[float] = None,
                     graphed: bool = False) -> None:
        """``graphed``: the batch's decode replayed a CUDA graph
        (decode/greedy.py)."""
        with self._lock:
            self.batches += 1
            self.graph_batches += graphed
            self.videos += n_videos
            self.clips += n_clips
            self.requests += n_videos
            self._lat.extend(latencies)
            if batch_seconds is not None:
                self._batch_s.append(batch_seconds)

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self.errors += n
            self.requests += n

    @staticmethod
    def _quantiles(samples) -> dict:
        s = sorted(samples)
        q = (lambda p: round(s[min(len(s) - 1, int(p * len(s)))] * 1e3, 2)
             if s else None)
        return {"p50": q(0.50), "p90": q(0.90), "p99": q(0.99)}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": self.requests,
                "errors": self.errors,
                "batches": self.batches,
                "videos": self.videos,
                "clips": self.clips,
                "decode_graph_batches": self.graph_batches,
                "mean_batch_videos": (round(self.videos / self.batches, 2)
                                      if self.batches else None),
                "latency_ms": self._quantiles(self._lat),
                "batch_ms": self._quantiles(self._batch_s),
            }


class DynamicBatcher:
    """Coalesce concurrent caption requests into fixed-shape device batches.

    One worker thread drains a queue: the first pending request opens a
    batch, further requests join until ``batch_videos`` slots fill or
    ``max_wait_ms`` passes, then the whole batch decodes in one call.
    submit() blocks the calling thread until its result is ready."""

    def __init__(self, service: CaptionService, max_wait_ms: float = 25.0,
                 max_batch: Optional[int] = None):
        self.service = service
        self.max_wait = max_wait_ms / 1e3
        self.max_batch = min(max_batch or service.batch_videos,
                             service.batch_videos)
        self.stats = ServingStats()
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="svpc-batcher", daemon=True)
        self._thread.start()

    def submit(self, entry: dict, timeout: Optional[float] = 60.0
               ) -> List[dict]:
        """Build the example (in the caller's thread), queue it, wait for
        the batched decode; returns the per-clip payload dicts."""
        if self._closed.is_set():
            raise RuntimeError("batcher is closed")
        # example-build failures propagate uncounted: the transport layer
        # owns client-error accounting
        p = _Pending(self.service.example_for(entry))
        self._q.put(p)
        if self._closed.is_set() and not p.done.is_set():
            # closed concurrently with the put: the worker may be gone
            p.abandoned = True
            if p.claim_accounting():
                self.stats.record_error()
            raise RuntimeError("batcher is closed")
        if not p.done.wait(timeout):
            p.abandoned = True
            if p.claim_accounting():
                self.stats.record_error()
            raise DecodeTimeout(
                f"decode did not complete within {timeout}s")
        if p.error is not None:
            raise p.error
        return p.result

    def close(self, timeout: float = 30.0) -> None:
        if not self._closed.is_set():
            self._closed.set()
            self._q.put(None)  # wake the worker
            self._thread.join(timeout)

    def _collect(self) -> Optional[List[_Pending]]:
        """Block for the first request, then fill the batch until the
        wait window closes or the batch is full."""
        first = self._q.get()
        if first is None:
            return None
        items = [first]
        deadline = time.perf_counter() + self.max_wait
        while len(items) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _loop(self) -> None:
        while True:
            items = self._collect()
            if items is None:
                return
            items = [p for p in items if not p.abandoned]
            if not items:
                if self._closed.is_set() and self._q.empty():
                    return
                continue
            try:
                t0 = time.perf_counter()
                payloads = self.service.decode_payloads(
                    [p.example for p in items])
                batch_s = time.perf_counter() - t0
                graphed = replayed_last()
                for p, clips in zip(items, payloads):
                    p.result = clips
                # only requests still owned by a waiter count
                mine = [p for p in items if p.claim_accounting()]
                self.stats.record_batch(
                    len(mine),
                    sum(p.example.meta["n_steps"] for p in mine),
                    [time.perf_counter() - p.t_submit for p in mine],
                    batch_seconds=batch_s, graphed=graphed)
            except Exception as e:  # surface to every waiter
                logger.exception("batched decode failed")
                err = DecodeFailure(f"batched decode failed: {e!r}")
                err.__cause__ = e
                for p in items:
                    p.error = err
                self.stats.record_error(
                    sum(1 for p in items if p.claim_accounting()))
            finally:
                for p in items:
                    p.done.set()
            if self._closed.is_set() and self._q.empty():
                return

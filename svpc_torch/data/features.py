"""Video feature store.

The reference loads ``{vid}_resnet.npy`` + ``{vid}_bn.npy`` per example from
disk inside ``__getitem__`` with no caching
(reference: recursive_caption_dataset.py:187-189).  Here feature IO is a
separate layer so the hot path (load → concat → span-index → downsample →
pad) stays in one place.  The hot path is the native C++ packer
(svpc_torch/native); the numpy fill below is its plain version.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from svpc_torch.data.anet import timestamp_to_feature_span


def npy_header(path: str):
    """(shape, dtype) from a .npy header alone — no data IO."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        reader = (np.lib.format.read_array_header_1_0 if version[0] == 1
                  else np.lib.format.read_array_header_2_0)
        shape, _, dtype = reader(f)
    return shape, dtype


class FeatureStore:
    """Loads and caches per-video ResNet+BN-Inception features."""

    def __init__(self, feature_dir: str, cache_size: int = 0):
        self.feature_dir = feature_dir
        self._cache: Dict[str, np.ndarray] = {}
        self._cache_size = cache_size
        self._rows: Dict[str, int] = {}

    def paths(self, video_name: str) -> Tuple[str, str]:
        return (
            os.path.join(self.feature_dir, f"{video_name}_resnet.npy"),
            os.path.join(self.feature_dir, f"{video_name}_bn.npy"),
        )

    def exists(self, video_name: str) -> bool:
        return all(os.path.exists(p) for p in self.paths(video_name))

    def load(self, video_name: str) -> np.ndarray:
        """(T, 3072) float32 = concat(resnet 2048, bn 1024)."""
        if video_name in self._cache:
            return self._cache[video_name]
        p_resnet, p_bn = self.paths(video_name)
        feat = np.concatenate([np.load(p_resnet), np.load(p_bn)], axis=1)
        feat = feat.astype(np.float32, copy=False)
        if self._cache_size and len(self._cache) < self._cache_size:
            self._cache[video_name] = feat
        return feat

    def invalidate(self) -> None:
        """Drop every python-side cache (loaded arrays + header row
        counts) AND the native packer's persistent mmaps.  Call after
        replacing feature files on disk — otherwise stale row counts
        could disagree with what the native fill re-reads (the packer
        also hard-bounds its writes and errors on such a mismatch)."""
        self._cache.clear()
        self._rows.clear()
        from svpc_torch.native import mmap_cache_clear
        mmap_cache_clear()

    def rows(self, video_name: str) -> int:
        """Feature row count from the .npy header alone (no data IO) —
        enough to compute every clip's valid length without touching the
        feature bytes (lazy pipeline)."""
        if video_name in self._rows:
            return self._rows[video_name]
        shape, _ = npy_header(self.paths(video_name)[0])
        self._rows[video_name] = shape[0]
        return shape[0]


def clip_valid_length(feat_len: int, timestamp, frm2sec: float,
                      max_v_len: int) -> int:
    """Number of [VID] rows a clip will occupy — the pure-math part of
    ``index_clip_features`` (no feature IO; drives the lazy pipeline)."""
    st, ed = timestamp_to_feature_span(feat_len, timestamp, frm2sec)
    return min(ed - st + 1, max_v_len - 2)


def fill_clip_features(raw_feat: np.ndarray, timestamps, frm2sec: float,
                       max_v_len: int, out: np.ndarray) -> None:
    """Numpy version of the native into-buffer fill: write each clip's
    rows into ``out[c, 1:valid+1]`` (out: (n_clips, total_len, D), zeroed;
    total_len may be smaller than max_v_len when the batch's span bucket
    is)."""
    for c, ts in enumerate(timestamps):
        feat, valid_l, _ = index_clip_features(
            raw_feat, ts, frm2sec, max_v_len, max_v_len)
        out[c, 1:valid_l + 1] = feat[1:valid_l + 1]


def index_clip_features(
    raw_feat: np.ndarray,
    timestamp: Tuple[float, float],
    frm2sec: float,
    max_v_len: int,
    total_len: int,
    feature_size: Optional[int] = None,
) -> Tuple[np.ndarray, int, int]:
    """Slice one clip's features into a fixed-length buffer.

    Layout matches the reference (recursive_caption_dataset.py:389-416):
    row 0 is the [CLS] slot (zeros), rows 1..valid hold the clip features
    (linspace-downsampled when the span exceeds ``max_v_len - 2``), the
    [SEP] slot and padding are zeros.  Returns (feat (total_len, D),
    valid_len, token pattern length) where valid_len is the number of [VID]
    rows.
    """
    max_v_l = max_v_len - 2
    feat_len = len(raw_feat)
    st, ed = timestamp_to_feature_span(feat_len, timestamp, frm2sec)
    indexed_feat_len = ed - st + 1

    dim = feature_size if feature_size is not None else raw_feat.shape[1]
    feat = np.zeros((total_len, dim), dtype=np.float32)
    if indexed_feat_len > max_v_l:
        idx = np.linspace(st, ed, max_v_l, endpoint=True).astype(np.int64)
        assert idx.max() < feat_len
        feat[1:max_v_l + 1] = raw_feat[idx]
        valid_l = max_v_l
    else:
        valid_l = ed - st + 1
        feat[1:valid_l + 1] = raw_feat[st:ed + 1]
    return feat, valid_l, indexed_feat_len

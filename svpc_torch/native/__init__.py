"""The native (C++) feature packer, loaded through ctypes.

``packer.cpp`` mmaps a video's ``_resnet.npy`` / ``_bn.npy`` files and
writes each clip's rows straight into the batch buffer (float32, or float16
widened exactly), on a small thread pool.  It is host code, not a kernel.
It is compiled with g++ on first use into ``build/svpc_torch_native/`` at
the repository root (``.gitignore`` lists ``build/``); the library's name
carries a hash of the source and flags, so an edited source is rebuilt and
a stale library never loaded.  Nothing is built at import time.

There is no quiet fallback: a failed build or load raises with g++'s
output.  The numpy fill is chosen only by asking for it (``use_native=
False`` in ``data/pipeline.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "packer.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "svpc_torch_native")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
build_seconds = None   # g++ wall time of this process's build (None: cached)


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libsvpc_native-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    global build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp],
                              capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"native packer: g++ not found ({e}); pass "
                           "use_native=False for the numpy fill") from e
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"native packer: g++ failed on {SRC}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial


def get_lib():
    """The loaded native library, built first if needed; raises if the
    build or the load fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"native packer: cannot load {path}: {e}") \
                from e
        lib.svpc_pack_video.restype = ctypes.c_int
        lib.svpc_pack_video.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64,  # expected_d: caller buffer row width
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.svpc_npy_rows.restype = ctypes.c_int64
        lib.svpc_npy_rows.argtypes = [ctypes.c_char_p]
        lib.svpc_mmap_cache_clear.restype = None
        lib.svpc_mmap_cache_clear.argtypes = []
        lib.svpc_mmap_cache_enable.restype = None
        lib.svpc_mmap_cache_enable.argtypes = [ctypes.c_int]
        _lib = lib
        return _lib


def pack_video_native(resnet_path: str, bn_path: str, timestamps,
                      frm2sec: float, max_v_len: int, total_len: int,
                      feature_size: int, n_threads: int = 2):
    """(n_clips, total_len, feature_size) f32 buffer + per-clip valid
    lengths, or None if the packer cannot read the files."""
    lib = get_lib()
    ts = np.ascontiguousarray(timestamps, dtype=np.float64)
    n_clips = ts.shape[0]
    out = np.zeros((n_clips, total_len, feature_size), dtype=np.float32)
    valid = np.zeros((n_clips,), dtype=np.int64)
    rc = lib.svpc_pack_video(
        resnet_path.encode(), bn_path.encode(),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n_clips), ctypes.c_double(frm2sec),
        ctypes.c_int64(max_v_len), ctypes.c_int64(total_len),
        ctypes.c_int64(feature_size),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_threads))
    _raise_pack_error(rc, resnet_path, total_len, feature_size)
    if rc != 0:
        return None
    return out, valid


def _raise_pack_error(rc: int, resnet_path: str, total_len: int,
                      feature_size: int) -> None:
    if rc == -3:
        raise ValueError(
            f"{resnet_path}: clip span exceeds the buffer's "
            f"total_len={total_len} — feature file replaced on disk after "
            f"valid lengths were computed?  Re-validate via "
            f"FeatureStore.invalidate()")
    if rc == -4:
        raise ValueError(
            f"{resnet_path}: resnet+bn feature dims on disk do not sum to "
            f"the model's video_feature_size={feature_size} — wrong "
            f"dataset's features, or a file replaced after validation")


def mmap_cache_clear() -> None:
    """Drop the packer's persistent file mappings (waits for in-flight
    packs).  Mappings rebuild lazily; use under memory pressure or after
    replacing feature files on disk.  NOTE: python-side caches
    (FeatureStore._rows/_cache) are separate — after replacing files call
    ``FeatureStore.invalidate()``, which clears both layers.  A process
    that never loaded the library holds no mapping: nothing to drop."""
    with _lock:
        lib = _lib
    if lib is not None:
        lib.svpc_mmap_cache_clear()


def mmap_cache_enable(on: bool) -> None:
    """Toggle the persistent mmap cache (on by default)."""
    get_lib().svpc_mmap_cache_enable(1 if on else 0)


def pack_video_into(resnet_path: str, bn_path: str, timestamps,
                    frm2sec: float, max_v_len: int,
                    out: np.ndarray, lo: int, n_threads: int = 2):
    """Fill ``out[lo:lo+n_clips]`` in place — the zero-extra-copy path of
    the lazy pipeline: feature bytes move exactly once, mmap -> the final
    batch buffer.

    ``out`` must be a zero-initialized C-contiguous float32 array of shape
    (N, total_len, D) with N >= lo + n_clips; ``total_len`` (the bucketed
    video span) is read off the buffer.  Returns the per-clip valid
    lengths, or None if the packer cannot read the files.
    """
    lib = get_lib()
    ts = np.ascontiguousarray(timestamps, dtype=np.float64)
    n_clips = ts.shape[0]
    N, total_len, feature_size = out.shape
    assert out.dtype == np.float32 and out.flags.c_contiguous
    assert 0 <= lo and lo + n_clips <= N, (lo, n_clips, N)
    valid = np.zeros((n_clips,), dtype=np.int64)
    base = out.ctypes.data + lo * total_len * feature_size * 4
    rc = lib.svpc_pack_video(
        resnet_path.encode(), bn_path.encode(),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(n_clips), ctypes.c_double(frm2sec),
        ctypes.c_int64(max_v_len), ctypes.c_int64(total_len),
        ctypes.c_int64(feature_size),
        ctypes.cast(base, ctypes.POINTER(ctypes.c_float)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n_threads))
    _raise_pack_error(rc, resnet_path, total_len, feature_size)
    if rc != 0:
        return None
    return valid

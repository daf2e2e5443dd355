"""The port's native feature packer (svpc_torch/native: packer.cpp built
with g++, loaded through ctypes) against svpc_tpu's and against the port's
numpy fill, on the CPU: the same files give the same bytes, its errors
raise svpc_tpu's messages, and its mmap cache follows the store."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _fixture(root):
    from svpc_torch.config import tiny_test_config
    from svpc_torch.data.pipeline import inference_entries
    from svpc_torch.data.synthetic import write_serving_fixture

    cfg = tiny_test_config("full")
    fx = write_serving_fixture(str(root), cfg, n_videos=4, min_clips=1,
                               max_clips=4, seed=3)
    data = {k: fx[k] for k in ("word2idx_path", "verb2idx_path",
                               "duration_file", "video_feature_dir")}
    return cfg, data, inference_entries(fx["specs"], cfg.model.max_n_sen)


def _bytes_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_packer_matches_svpc_tpu_and_the_numpy_fill(tmp_path):
    """A float32 store and its ``convert_features`` float16 copy, each
    through the eager fill (``pack_video_native`` per example, dense
    batch) and the lazy fill (``pack_video_into`` straight into the packed
    batch, on one and on two fill threads): the port's native batch is
    byte-equal to its numpy batch and to svpc_tpu's native batch; the
    ``FILLS`` counter names the route."""
    from svpc_torch.cli.convert_features import convert_tree
    from svpc_torch.data import pipeline
    from svpc_torch.data.packing import pack_examples
    from svpc_torch.data.pipeline import CaptionDataset, batch_examples
    from svpc_tpu.config import tiny_test_config as jax_tiny
    from svpc_tpu.data.packing import pack_examples as jax_pack_examples
    from svpc_tpu.data.pipeline import CaptionDataset as JaxDataset
    from svpc_tpu.data.pipeline import batch_examples as jax_batch_examples

    cfg, data, entries = _fixture(tmp_path)
    f16_dir = str(tmp_path / "features_f16")
    assert convert_tree(data["video_feature_dir"], f16_dir) == 8
    T = cfg.model.max_t_len
    for feat_dir in (data["video_feature_dir"], f16_dir):
        paths = dict(data, video_feature_dir=feat_dir)
        for lazy in (False, True):
            built = {}
            for name, native in (("native", True), ("numpy", False)):
                ds = CaptionDataset(cfg.replace_data(**paths), "infer",
                                    entries=entries, use_native=native,
                                    lazy_features=lazy)
                pipeline.reset_fills()
                ex = [ds[i] for i in range(len(ds))]
                built[name] = (
                    batch_examples(ex) if not lazy else
                    pack_examples(ex, T, clip_multiple=4, v_multiple=4,
                                  fill_workers=2 if native else 0))
                assert dict(pipeline.FILLS) == {name: len(ex)}, \
                    (feat_dir, lazy, dict(pipeline.FILLS))
            jds = JaxDataset(jax_tiny("full").replace_data(**paths), "infer",
                             entries=entries, use_native=True,
                             lazy_features=lazy)
            jex = [jds[i] for i in range(len(jds))]
            built["svpc_tpu"] = (jax_batch_examples(jex) if not lazy else
                                 jax_pack_examples(jex, T, clip_multiple=4,
                                                   v_multiple=4))
            _bytes_equal(built["native"], built["numpy"])
            _bytes_equal(built["native"], built["svpc_tpu"])


def test_half_to_float_exact_on_every_value(tmp_path):
    """All 65,536 float16 bit patterns through the packer: the F16C path
    (2048 columns) and the scalar ``half_to_float`` (7 columns, below one
    8-lane vector) give svpc_tpu's packer's bytes, and numpy's widening
    cast bit for bit (every NaN too on the scalar path; the F16C hardware
    quiets signalling NaNs, so there NaNs compare as NaNs)."""
    from svpc_torch.native import pack_video_native
    from svpc_tpu.native import pack_video_native as jax_pack

    h = np.arange(65536, dtype=np.uint16).view(np.float16)
    for cols in (2048, 7):
        rows = -(-65536 // cols)
        resnet = np.resize(h, rows * cols).reshape(rows, cols)
        r, b = tmp_path / f"{cols}_resnet.npy", tmp_path / f"{cols}_bn.npy"
        np.save(r, resnet)
        np.save(b, np.zeros((rows, 3), np.float16))
        args = (str(r), str(b),
                np.array([[0.0, float(rows - 1)]]), 1.0, rows + 2, rows + 2,
                cols + 3)
        out, valid = pack_video_native(*args)
        jout, jvalid = jax_pack(*args)
        assert int(valid[0]) == rows == int(jvalid[0])
        assert out.tobytes() == jout.tobytes(), cols
        got = out[0, 1:rows + 1, :cols].view(np.uint32)
        want = resnet.astype(np.float32).view(np.uint32)
        if cols == 7:
            np.testing.assert_array_equal(got, want)
        else:
            nan = np.isnan(resnet)
            np.testing.assert_array_equal(np.isnan(got.view(np.float32)),
                                          nan)
            np.testing.assert_array_equal(got[~nan], want[~nan])


def test_errors_raise_as_svpc_tpu_and_a_failed_build_raises(tmp_path,
                                                            monkeypatch):
    """Error -3 (a clip span beyond the buffer) and -4 (feature widths not
    summing to the buffer's row) raise svpc_tpu's ValueError texts; an
    unreadable file makes the pipeline raise (no quiet numpy fill); a
    source g++ cannot compile raises with g++'s output."""
    import svpc_torch.native as native
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_tpu.native import pack_video_into as jax_into

    rng = np.random.RandomState(0)
    np.save(tmp_path / "v_resnet.npy", rng.randn(40, 5).astype(np.float32))
    np.save(tmp_path / "v_bn.npy", rng.randn(40, 3).astype(np.float32))
    paths = (str(tmp_path / "v_resnet.npy"), str(tmp_path / "v_bn.npy"))
    ts = np.array([[0.0, 30.0]])
    for shape in ((1, 12, 8), (1, 40, 9)):    # -3: 30 rows > 12; -4: 5+3 != 9
        msgs = []
        for pack in (native.pack_video_into, jax_into):
            with pytest.raises(ValueError) as e:
                pack(*paths, ts, 1.0, 40, np.zeros(shape, np.float32), 0)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], msgs

    cfg, data, entries = _fixture(tmp_path / "fx")
    os.remove(os.path.join(data["video_feature_dir"], "vid000_bn.npy"))
    np.save(os.path.join(data["video_feature_dir"], "vid000_bn.npy"),
            np.zeros((3,), np.float32))          # not 2-D: unreadable
    for lazy in (False, True):
        ds = CaptionDataset(cfg.replace_data(**data), "infer",
                            entries=entries[:1], lazy_features=lazy)
        with pytest.raises(ValueError, match="native packer cannot read"):
            ex = ds[0]
            if lazy:
                from svpc_torch.data.packing import pack_examples
                pack_examples([ex], cfg.model.max_t_len)

    broken = tmp_path / "packer.cpp"
    broken.write_text("int svpc_pack_video( {\n")
    monkeypatch.setattr(native, "SRC", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error:"):
        native.get_lib()


def test_invalidate_and_mmap_cache_follow_the_files(tmp_path):
    """The packer keeps each file mapped (the mmap cache): a feature file
    replaced on disk is read anew after ``FeatureStore.invalidate()`` (as
    in svpc_tpu, it clears the mappings and the header rows); a clear and
    a disabled cache give the same bytes."""
    from svpc_torch.data.features import FeatureStore
    from svpc_torch.native import (mmap_cache_clear, mmap_cache_enable,
                                   pack_video_native)

    rng = np.random.RandomState(1)
    store = FeatureStore(str(tmp_path))
    p_r, p_b = store.paths("v")
    np.save(p_r, rng.randn(30, 4).astype(np.float32))
    np.save(p_b, rng.randn(30, 2).astype(np.float32))
    args = (p_r, p_b, np.array([[0.0, 20.0], [3.0, 9.0]]), 1.0, 24, 24, 6)
    a, va = pack_video_native(*args)
    assert store.rows("v") == 30
    mmap_cache_clear()
    b, vb = pack_video_native(*args)
    mmap_cache_enable(False)
    try:
        c, vc = pack_video_native(*args)
    finally:
        mmap_cache_enable(True)
    for x, v in ((b, vb), (c, vc)):
        assert x.tobytes() == a.tobytes() and np.array_equal(v, va)

    new_r = rng.randn(30, 4).astype(np.float32)
    os.replace(_saved(tmp_path, new_r), p_r)   # a new inode, as an upload
    stale, _ = pack_video_native(*args)
    assert stale.tobytes() == a.tobytes()       # still the cached mapping
    store.invalidate()
    fresh, _ = pack_video_native(*args)
    assert not store._rows
    np.testing.assert_array_equal(fresh[0, 1:22, :4], new_r[0:21])


def _saved(root, arr):
    path = os.path.join(root, "next.npy")
    np.save(path, arr)
    return path

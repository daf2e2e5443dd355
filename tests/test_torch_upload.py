"""Feature uploads in svpc_torch's serving (``upload_dir``,
``put_features``, the request body's inline ``features``) and the port's
``CaptionClient``, against the disk-staged features of the same videos
and against svpc_tpu's CaptionService with carried weights, on the CPU."""

import base64
import io
import os

import numpy as np
import pytest
import torch

from tests.torch_parity import jax_model, port_model

torch.set_num_threads(1)

MODE = "full"


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    from svpc_torch.data.synthetic import write_serving_fixture

    cfg, _ = port_model(MODE)
    root = str(tmp_path_factory.mktemp("upload"))
    fx = write_serving_fixture(root, cfg, n_videos=4, min_clips=1,
                               max_clips=cfg.model.max_n_sen, seed=5)
    with open(fx["duration_file"]) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    fx["durations"] = {r[0]: (float(r[1]), float(r[2])) for r in rows}
    return fx


def _data(fx):
    return {k: fx[k] for k in ("word2idx_path", "verb2idx_path",
                               "duration_file", "video_feature_dir")}


def _features(fx, vid, dtype=np.float32):
    return {kind: np.load(os.path.join(fx["video_feature_dir"],
                                       f"{vid}_{kind}.npy")).astype(dtype)
            for kind in ("resnet", "bn")}


def _b64(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode()


def _sentences(captions):
    return {v: [c["sentence"] for c in clips] for v, clips in captions.items()}


def _port_service(fx, **kw):
    from svpc_torch.serving import CaptionService

    cfg, model = port_model(MODE)
    return CaptionService(cfg.replace_data(**_data(fx)), model,
                          device="cpu", warmup=False, **kw)


def test_uploads_caption_as_disk_and_as_svpc_tpu(fixture, tmp_path):
    """Every fixture video uploaded under a new id (float32 and float16
    payloads): its captions equal the disk-staged video's and svpc_tpu's
    service's after the same uploads; the spool holds float32 files and
    no temporary file; a re-upload of an id with another video's features
    replaces them (the store and the packer's mappings are invalidated)."""
    from svpc_tpu.serving import CaptionService as JaxCaptionService

    svc = _port_service(fixture, batch_videos=2,
                        upload_dir=str(tmp_path / "port"))
    jcfg, jmodel, params = jax_model(MODE)
    jsvc = JaxCaptionService(jcfg.replace_data(**_data(fixture)), jmodel,
                             params, batch_videos=2, warmup=False,
                             upload_dir=str(tmp_path / "jax"))
    disk = _sentences(svc.caption(fixture["specs"]))
    up_specs = {}
    for i, (vid, spec) in enumerate(fixture["specs"].items()):
        duration, n_frames = fixture["durations"][vid]
        feats = _features(fixture, vid, np.float16 if i % 2 else np.float32)
        body = dict(spec, duration=duration, n_frames=n_frames,
                    features={k: _b64(v) for k, v in feats.items()})
        entry = svc.make_entry(f"up_{vid}", body)
        assert entry["source"] == "upload"
        jsvc.make_entry(f"up_{vid}", body)
        up_specs[f"up_{vid}"] = spec
    spool = tmp_path / "port"
    assert {np.load(p).dtype for p in spool.glob("*.npy")} == \
        {np.dtype(np.float32)}
    assert not list(spool.glob("*.tmp.npy"))
    got = _sentences(svc.caption(up_specs))
    assert got == {f"up_{v}": s for v, s in disk.items()}
    assert got == _sentences(jsvc.caption(up_specs))

    # the f16 payload widened exactly: the spool's bytes are the widened
    # float16 features
    vid1 = list(fixture["specs"])[1]
    np.testing.assert_array_equal(
        np.load(spool / f"up_{vid1}_bn.npy"),
        _features(fixture, vid1, np.float16)["bn"].astype(np.float32))

    a, b = list(fixture["specs"])[:2]
    duration, n_frames = fixture["durations"][b]
    svc.put_features(f"up_{a}", {k: _b64(v) for k, v in
                                 _features(fixture, b).items()},
                     duration, n_frames)
    spec_b = fixture["specs"][b]
    assert _sentences(svc.caption({f"up_{a}": spec_b}))[f"up_{a}"] == disk[b]


def test_traversal_guard_and_refusals(fixture, tmp_path):
    """Ids that could escape the spool are refused before any write;
    without --upload_dir inline features are refused; bad payloads,
    dims and durations are client errors; a serving batch that the mesh's
    dp axis does not divide is refused."""
    from svpc_torch.serving import CaptionService, ServingError

    svc = _port_service(fixture, batch_videos=1,
                        upload_dir=str(tmp_path / "spool"))
    vid, spec = next(iter(fixture["specs"].items()))
    duration, n_frames = fixture["durations"][vid]
    feats = {k: _b64(v) for k, v in _features(fixture, vid).items()}
    good = dict(spec, duration=duration, n_frames=n_frames, features=feats)
    for bad in ("../evil", "a/b", ".hidden", "", "x/../../y"):
        with pytest.raises(ServingError, match="invalid video_id"):
            svc.make_entry(bad, good)
    assert os.listdir(tmp_path / "spool") == []
    assert not (tmp_path / "evil_resnet.npy").exists()

    with pytest.raises(ServingError, match="disabled"):
        _port_service(fixture, batch_videos=1).make_entry("v", good)
    wide = _features(fixture, vid)
    for body, match in (
            (dict(good, duration=None), "duration"),
            (dict(good, n_frames=0), "> 0"),
            (dict(good, features={"resnet": feats["resnet"]}), "'bn'"),
            (dict(good, features=dict(feats, bn="not base64 npy")),
             "features.bn"),
            (dict(good, features=dict(feats, bn=_b64(wide["bn"][:, :2]))),
             "video_feature_size"),
            (dict(good, features=dict(feats, bn=_b64(wide["bn"][:3]))),
             "equal rows")):
        with pytest.raises(ServingError, match=match):
            svc.make_entry("fresh", body)
    with pytest.raises(ServingError, match="or upload them"):
        svc.make_entry("never_uploaded", spec)
    from svpc_torch.parallel.mesh import Mesh

    cfg, model = port_model(MODE)
    with pytest.raises(ValueError, match="multiple of the dp mesh axis"):
        CaptionService(cfg.replace_data(**_data(fixture)), model,
                       batch_videos=3, mesh=Mesh(2, 1, 0, 0), warmup=False,
                       device="cpu")


def test_caption_client_uploads_through_the_daemon(fixture, tmp_path):
    """svpc_torch.client.CaptionClient against the port's HTTP daemon with
    an upload spool: an inline upload captions as the disk-staged video,
    a follow-up without features finds the spool, and daemon errors reach
    the client as CaptionClientError with their HTTP code."""
    from svpc_torch.cli.serve import start_server, stop_server
    from svpc_torch.client import CaptionClient, CaptionClientError

    svc = _port_service(fixture, batch_videos=2,
                        upload_dir=str(tmp_path / "spool"))
    vid, spec = list(fixture["specs"].items())[2]
    want = _sentences(svc.caption({vid: spec}))[vid]
    duration, n_frames = fixture["durations"][vid]
    feats = _features(fixture, vid)
    server = start_server(svc, port=0, max_wait_ms=5)
    client = CaptionClient("http://127.0.0.1:%d" % server.server_address[1])
    try:
        # a daemon with a spool takes feature payloads up to 1 GiB
        assert server.max_request_bytes == 1 << 30
        assert client.health()["status"] == "ok"
        resp = client.caption("brand_new", spec["timestamps"],
                              spec["ingredients"], resnet=feats["resnet"],
                              bn=feats["bn"], duration=duration,
                              n_frames=n_frames)
        assert [c["sentence"] for c in resp["captions"]] == want
        resp = client.caption("brand_new", spec["timestamps"],
                              spec["ingredients"])
        assert [c["sentence"] for c in resp["captions"]] == want
        with pytest.raises(CaptionClientError) as e:
            client.caption("v2", spec["timestamps"], [],
                           resnet=feats["resnet"], bn=feats["bn"])
        assert e.value.code == 400 and "duration" in e.value.message
        with pytest.raises(ValueError, match="BOTH"):
            client.caption("v3", spec["timestamps"], [],
                           resnet=feats["resnet"])
        stats = client.stats()
        assert stats["requests"] == 3 and stats["errors"] == 1
    finally:
        stop_server(server)


def test_decode_examples_matches_svpc_tpu(fixture):
    """CaptionService.decode_examples: one postprocessed sentence per real
    clip, equal to svpc_tpu's on the same examples and weights."""
    from svpc_tpu.serving import CaptionService as JaxCaptionService

    svc = _port_service(fixture, batch_videos=4)
    jcfg, jmodel, params = jax_model(MODE)
    jsvc = JaxCaptionService(jcfg.replace_data(**_data(fixture)), jmodel,
                             params, batch_videos=4, warmup=False)
    specs = fixture["specs"]
    got = svc.decode_examples([svc.example_for(svc.make_entry(v, s))
                               for v, s in specs.items()])
    want = jsvc.decode_examples([jsvc.example_for(jsvc.make_entry(v, s))
                                 for v, s in specs.items()])
    assert got == want
    assert [len(s) for s in got] == [len(s["timestamps"])
                                     for s in specs.values()]

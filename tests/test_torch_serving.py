"""svpc_torch serving against svpc_tpu serving on one on-disk fixture
(svpc_torch.data.synthetic.write_serving_fixture), with carried weights:
identical sentences; the dynamic batcher coalesces concurrent submits;
the HTTP daemon answers /healthz, /v1/captions and /v1/stats."""

import http.client
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from tests.torch_parity import jax_model, port_model

torch.set_num_threads(1)

MODE = "full"


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    from svpc_torch.data.synthetic import write_serving_fixture

    cfg, _ = port_model(MODE)
    root = str(tmp_path_factory.mktemp("serving"))
    return write_serving_fixture(root, cfg, n_videos=5, min_clips=1,
                                 max_clips=cfg.model.max_n_sen, seed=3)


def _data(fx):
    return dict(word2idx_path=fx["word2idx_path"],
                verb2idx_path=fx["verb2idx_path"],
                duration_file=fx["duration_file"],
                video_feature_dir=fx["video_feature_dir"])


def _port_service(fx, **kw):
    from svpc_torch.serving import CaptionService

    cfg, model = port_model(MODE)
    return CaptionService(cfg.replace_data(**_data(fx)), model,
                          device="cpu", **kw)


def test_service_matches_jax_service(fixture):
    """Packed (the serving default) and dense batch layouts."""
    from svpc_tpu.serving import CaptionService as JaxCaptionService
    from svpc_torch.serving import CaptionService

    jcfg, jmodel, params = jax_model(MODE)
    cfg, model = port_model(MODE)
    for packed in (True, False):
        want = JaxCaptionService(
            jcfg.replace_data(**_data(fixture)).replace_train(
                pack_clips=packed),
            jmodel, params, batch_videos=2,
            warmup=False).caption(fixture["specs"])
        got = CaptionService(
            cfg.replace_data(**_data(fixture)).replace_train(
                pack_clips=packed),
            model, batch_videos=2, warmup=False,
            device="cpu").caption(fixture["specs"])
        assert got == want, packed
        assert sum(len(v) for v in got.values()) == sum(
            len(s["timestamps"]) for s in fixture["specs"].values())


def test_batcher_coalesces_concurrent_submits(fixture):
    from svpc_torch.serving import DynamicBatcher

    svc = _port_service(fixture, batch_videos=4)
    batcher = DynamicBatcher(svc, max_wait_ms=500)
    specs = list(fixture["specs"].items())[:4]
    entries = [svc.make_entry(v, s) for v, s in specs]
    results = [None] * len(entries)

    def run(i):
        results[i] = batcher.submit(entries[i], timeout=60)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(entries))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
    finally:
        batcher.close()
    stats = batcher.stats.snapshot()
    assert stats["requests"] == 4 and stats["errors"] == 0
    assert stats["batches"] < 4  # at least one batch held several videos
    for (vid, spec), res in zip(specs, results):
        assert len(res) == len(spec["timestamps"])
    solo = svc.caption(dict(specs))
    assert [[c["sentence"] for c in solo[v]] for v, _ in specs] == \
        [[c["sentence"] for c in r] for r in results]


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_answers_the_api(fixture):
    from svpc_torch.cli.serve import start_server, stop_server

    server = start_server(_port_service(fixture, batch_videos=2),
                          port=0, max_wait_ms=5)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        code, health = _call(base + "/healthz")
        assert code == 200 and health["status"] == "ok"
        assert health["device"] == "cpu"
        vid, spec = next(iter(fixture["specs"].items()))
        code, resp = _call(base + "/v1/captions", dict(spec, video_id=vid))
        assert code == 200 and resp["video_id"] == vid
        assert len(resp["captions"]) == len(spec["timestamps"])
        code, resp = _call(base + "/v1/captions",
                           {"video_id": "nope", "timestamps": [[0, 1]]})
        assert code == 400 and "no feature files" in resp["error"]
        code, stats = _call(base + "/v1/stats")
        assert code == 200
        assert stats["requests"] == 2 and stats["errors"] == 1
        assert stats["batches"] == 1
        # a daemon without an upload spool refuses bodies over 1 MiB
        # before reading them
        conn = http.client.HTTPConnection(*server.server_address,
                                          timeout=60)
        conn.putrequest("POST", "/v1/captions")
        conn.putheader("Content-Length", str((1 << 20) + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert "bad Content-Length" in json.loads(resp.read())["error"]
        conn.close()
    finally:
        stop_server(server)


def test_clip_buckets_pick_the_smallest_cover(fixture):
    """A light batch rides the smallest packed clip bucket covering its
    real clips; the worst case (every slot a full video) always fits."""
    from svpc_torch.serving import CaptionService

    cfg, model = port_model(MODE)
    cfg = cfg.replace_data(**_data(fixture)).replace_train(
        pack_clip_multiple=4)
    svc = CaptionService(cfg, model, batch_videos=4, clip_buckets=[4, 8],
                         warmup=False, device="cpu")
    assert svc._buckets == [4, 8, 16]
    for vid, spec in fixture["specs"].items():
        ex = svc.example_for(svc.make_entry(vid, spec))
        n = len(spec["timestamps"])
        assert svc.build_batch([ex])["clip_mask"].shape[0] == \
            (4 if n <= 4 else 8)

"""svpc_torch's serving on a dp x tp mesh of gloo CPU ranks (each a
process, started as torchrun starts them): ``CaptionService(mesh=...)``
at dp2 and at tp2, greedy and beam K=2 with two ranked hypotheses, and
``cli.serve --dp_size 2`` / ``--tp_size 2`` over HTTP give the
one-process captions sentence for sentence; a follower that fails takes
rank 0's server down with it; a batch the dp axis does not
divide and ``--pp_size 2`` on every inference CLI are refused as svpc_tpu
refuses them.  Tiny geometry on a training fixture, from a one-epoch
trainer checkpoint."""

import concurrent.futures
import json
import os
import signal
import time
import urllib.error
import urllib.request

import pytest
import torch

torch.set_num_threads(1)

RANK_TIMEOUT = 60
ENV = {"OMP_NUM_THREADS": "1"}
DECODERS = [(0, 1), (2, 2)]   # (beam_size, n_best): greedy, beam2_n2


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A training fixture, its CLI data flags, a one-epoch checkpoint and
    four videos' request specs."""
    from svpc_torch.cli.train import main as train_main
    from tests.test_torch_parallel_loop import GEOMETRY, _fixture

    root = tmp_path_factory.mktemp("serve_mesh")
    data = _fixture(root)
    workdir = str(root / "run")
    train_main(data + GEOMETRY + ["--batch_size", "2", "--n_epoch", "1",
                                  "--max_steps_per_epoch", "2", "--lr",
                                  "1e-3", "--no_tensorboard",
                                  "--no_language_eval", "--workdir",
                                  workdir])
    with open(os.path.join(data[data.index("--data_dir") + 1],
                           "bosselut_split_yc2_val_anet_format.json")) as f:
        specs = {vid: {"timestamps": a["timestamps"],
                       "ingredients": a["ingredients"]}
                 for vid, a in json.load(f).items()}
    return dict(data=data, checkpoint=workdir + "/checkpoint_last",
                specs=specs, root=root)


def _one_process(trained, beam_size, n_best):
    from svpc_torch.config import Config
    from svpc_torch.model import SVPCModel
    from svpc_torch.serving import CaptionService
    from svpc_torch.train.state import load_eval_weights

    ckpt = trained["checkpoint"]
    cfg = Config.from_json(ckpt + ".cfg.json")
    model = SVPCModel(cfg.model)
    model.load_state_dict(load_eval_weights(ckpt), strict=True)
    svc = CaptionService(cfg, model, batch_videos=2, beam_size=beam_size,
                         n_best=n_best, warmup=False, device="cpu")
    return svc.caption(trained["specs"])


def _entries(captions):
    return {v: [(c["sentence"], [h["sentence"] for h in c.get("nbest", [])])
                for c in clips] for v, clips in captions.items()}


def test_caption_service_on_dp2_and_tp2_matches_one_process(trained):
    """Two videos a batch: at dp2 each rank decodes one (its own block,
    filled on its own), at tp2 each holds 2 of the 4 heads and half the
    vocabulary; greedy and beam2_n2 captions equal one process's."""
    from svpc_torch.parallel.worker import run_job

    want = [_entries(_one_process(trained, *d)) for d in DECODERS]
    assert all(want)
    for dp, tp in ((2, 1), (1, 2)):
        out = str(trained["root"] / f"job_dp{dp}tp{tp}")
        run_job("serve", dict(checkpoint=trained["checkpoint"],
                              batch_videos=2, decoders=DECODERS,
                              specs=trained["specs"], device="cpu", dp=dp,
                              tp=tp, out=out), 2, RANK_TIMEOUT, ENV)
        with open(os.path.join(out, "result.json")) as f:
            got = [_entries(c) for c in json.load(f)]
        assert got == want, (dp, tp)
        for r in range(2):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                heads = json.load(f)["heads"]
            assert set(heads) == {"4" if tp == 1 else "2"}, (dp, tp, heads)


def _post(url, body):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_cli_serve_on_dp2_and_tp2_answers_as_one_process(trained):
    """cli.serve --dp_size 2 (and --tp_size 2) on two ranks: rank 0
    listens, concurrent requests coalesce into batches both ranks
    decode, the captions equal one process's; on SIGTERM rank 0 drains
    and the follower exits with it."""
    from svpc_torch.parallel.mesh import free_port
    from svpc_torch.parallel.worker import Ranks

    want = _entries(_one_process(trained, 0, 1))
    for flag in ("--dp_size", "--tp_size"):
        port = free_port()
        ranks = Ranks(["svpc_torch.cli.serve", *trained["data"],
                       "--checkpoint", trained["checkpoint"], "--port",
                       str(port), "--batch_videos", "2", flag, "2"], 2,
                      str(trained["root"] / f"serve_logs{flag}"), ENV)
        url = f"http://127.0.0.1:{port}"
        try:
            t0 = time.perf_counter()
            while True:
                assert ranks.failed() is None, ranks.tails()
                assert time.perf_counter() - t0 < RANK_TIMEOUT, ranks.tails()
                try:
                    urllib.request.urlopen(url + "/healthz", timeout=5)
                    break
                except (urllib.error.URLError, ConnectionError):
                    time.sleep(0.2)
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                replies = list(pool.map(
                    lambda kv: _post(url + "/v1/captions",
                                     dict(kv[1], video_id=kv[0])),
                    trained["specs"].items()))
            got = _entries({r["video_id"]: r["captions"] for r in replies})
            assert got == want, flag
            ranks.procs[0].send_signal(signal.SIGTERM)
            ranks.wait(RANK_TIMEOUT)
        finally:
            ranks.kill()


def test_cli_serve_exits_when_a_follower_fails(trained):
    """cli.serve --dp_size 2 whose follower's fill of a batch raises: the
    follower exits, the batch is answered 502, and rank 0 stops listening
    and exits non-zero on its own instead of serving on out of step."""
    from svpc_torch.parallel.mesh import free_port
    from svpc_torch.parallel.worker import Ranks

    port = free_port()
    out = str(trained["root"] / "serve_fail")
    os.makedirs(out, exist_ok=True)
    spec = dict(device="cpu", backend="gloo", timeout_s=RANK_TIMEOUT,
                out=out, fail_rank=1,
                argv=[*trained["data"], "--checkpoint",
                      trained["checkpoint"], "--port", str(port),
                      "--batch_videos", "2", "--device", "cpu",
                      "--dp_size", "2"])
    with open(os.path.join(out, "spec.json"), "w") as f:
        json.dump(spec, f)
    ranks = Ranks(["svpc_torch.parallel.worker", "cli_serve",
                   os.path.join(out, "spec.json")], 2, out, ENV)
    url = f"http://127.0.0.1:{port}"
    vid, first = next(iter(trained["specs"].items()))
    try:
        t0 = time.perf_counter()
        while True:
            assert ranks.failed() is None, ranks.tails()
            assert time.perf_counter() - t0 < RANK_TIMEOUT, ranks.tails()
            try:
                urllib.request.urlopen(url + "/healthz", timeout=5)
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.2)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/v1/captions", dict(first, video_id=vid))
        assert e.value.code == 502
        codes = [p.wait(RANK_TIMEOUT) for p in ranks.procs]
        assert codes[0] != 0 and codes[1] != 0, (codes, ranks.tails())
        assert "the mesh failed" in ranks.tails()
        with pytest.raises((urllib.error.URLError, ConnectionError)):
            urllib.request.urlopen(url + "/healthz", timeout=5)
    finally:
        ranks.kill()


def test_refusals(trained, capsys):
    """batch_videos must divide over dp (svpc_tpu's message), and
    --pp_size 2 on cli.evaluate, cli.serve, cli.caption and
    cli.dump_memories is a usage error with svpc_tpu's reject_pp text."""
    from svpc_torch.cli import caption, dump_memories, evaluate, serve
    from svpc_torch.config import Config
    from svpc_torch.model import SVPCModel
    from svpc_torch.parallel.mesh import Mesh
    from svpc_torch.serving import CaptionService

    cfg = Config.from_json(trained["checkpoint"] + ".cfg.json")
    with pytest.raises(ValueError, match="batch_videos=3 must be a multiple "
                                         r"of the dp mesh axis \(2\)"):
        CaptionService(cfg, SVPCModel(cfg.model), batch_videos=3,
                       mesh=Mesh(2, 1, 0, 0), warmup=False, device="cpu")
    ckpt = ["--checkpoint", trained["checkpoint"]]
    for main, extra in (
            (evaluate.main, ["--output_dir", "x"]),
            (serve.main, []),
            (caption.main, ["--input_json", "x", "--output", "y"]),
            (dump_memories.main, ["--output_dir", "x"])):
        with pytest.raises(SystemExit) as e:
            main(trained["data"] + ckpt + extra + ["--pp_size", "2"])
        assert e.value.code == 2
        assert "--pp_size applies to cli.train only" in \
            capsys.readouterr().err, main

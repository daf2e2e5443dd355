"""The greedy decode loop as a CUDA graph (svpc_torch/decode/greedy.py):
where it engages, what its key follows, and what the serving counters
report.  It imports nothing but torch, pytest and svpc_torch, so the
card test runs on the card's machine (no JAX) with
``python -m pytest --noconftest -m cuda tests/test_torch_decode_graph.py``;
on the CPU the card test skips."""

import copy
import json
import pickle
import urllib.request

import pytest
import torch

torch.set_num_threads(1)


def _model(mode: str, dtype: str = "float32", seed: int = 0):
    from svpc_torch.config import tiny_test_config
    from svpc_torch.model import SVPCModel

    cfg = tiny_test_config(mode)
    if dtype != "float32":
        cfg = cfg.replace_model(compute_dtype=dtype)
    return cfg, SVPCModel(cfg.model,
                          torch.Generator().manual_seed(seed)).eval()


def _packed(cfg, seed: int, device="cpu"):
    """A packed batch of 3 videos at one fixed shape (16 clip rows, the
    whole video span) whatever the seed."""
    from svpc_torch.data.packing import pack_batch
    from svpc_torch.data.synthetic import synthetic_batch
    from svpc_torch.model.svpc import to_tensors

    m = cfg.model
    b = pack_batch(synthetic_batch(cfg, 3, seed=seed), m.max_t_len,
                   n_clips=16, v_len=m.max_v_len)
    return to_tensors(b, torch.device(device),
                      torch.bfloat16 if m.compute_dtype == "bfloat16"
                      else torch.float32)


def _loop_inputs(model, batch):
    from svpc_torch.decode.greedy import loop_inputs
    from svpc_torch.model.svpc import clip_view

    with torch.no_grad():
        state = model.encode(batch)
    return loop_inputs(model, state, clip_view(batch))


@pytest.mark.parametrize("mode", ["full", "video"])
def test_cpu_decode_takes_the_eager_loop(mode):
    """On the CPU no graph is made: every decode counts as eager, and
    ``graph=False`` changes nothing."""
    from svpc_torch.decode import greedy

    cfg, model = _model(mode)
    batch = _packed(cfg, 5)
    greedy.reset_graphs()
    got = greedy.greedy_decode(model, batch)
    assert greedy.GRAPHS == {"captured": 0, "replayed": 0, "eager": 1}
    assert not greedy.replayed_last()
    assert getattr(model, "_decode_graphs", None) is None
    assert torch.equal(got, greedy.greedy_decode(model, batch, graph=False))
    assert greedy.GRAPHS["eager"] == 2


def test_graph_key_follows_parameter_storage():
    """An in-place update keeps the key (the graph reads the new values
    where the old ones lay); a parameter replaced by a new tensor, another
    shape or the train flag changes it."""
    from svpc_torch.decode.greedy import graph_key

    cfg, model = _model("full")
    inputs = _loop_inputs(model, _packed(cfg, 5))
    key = graph_key(model, inputs)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    model.load_state_dict(copy.deepcopy(model.state_dict()))
    assert graph_key(model, inputs) == key
    assert graph_key(model, _loop_inputs(model, _packed(cfg, 6))) == key

    fewer = dict(inputs, ga_inputs=inputs["ga_inputs"][:8])
    assert graph_key(model, fewer) != key
    model.train()
    assert graph_key(model, inputs) != key
    model.eval()
    ln = model.decoder.layer[0].norm1
    ln.weight = torch.nn.Parameter(ln.weight.detach().clone())
    assert graph_key(model, inputs) != key


def test_tp_or_pp_mesh_is_not_eligible():
    from svpc_torch.decode.greedy import graph_eligible
    from svpc_torch.parallel.mesh import Mesh

    _, model = _model("video")
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    assert graph_eligible(model, cuda) and not graph_eligible(model, cpu)
    model.mesh = Mesh(dp_size=2, tp_size=1, dp_index=1, tp_index=0)
    assert graph_eligible(model, cuda)
    model.mesh = Mesh(dp_size=1, tp_size=2, dp_index=0, tp_index=1)
    assert not graph_eligible(model, cuda)
    model.mesh = Mesh(dp_size=2, tp_size=1, dp_index=0, tp_index=0,
                      pp_size=2)
    assert not graph_eligible(model, cuda)


def test_graph_cache_copies_start_empty():
    """A deepcopy or a pickle of a model (or of its cache) carries no
    captured graph and shares no lock."""
    from svpc_torch.decode.greedy import decode_graphs

    _, model = _model("video")
    graphs = decode_graphs(model)
    assert decode_graphs(model) is graphs and not graphs.entries
    graphs.entries["key"] = object()
    twin = copy.deepcopy(model)
    assert not decode_graphs(twin).entries
    assert decode_graphs(twin).lock is not graphs.lock
    assert not pickle.loads(pickle.dumps(graphs)).entries
    assert len(graphs.entries) == 1


def test_graph_cache_keeps_every_shape_until_the_weights_move(monkeypatch):
    """However many shapes a caller decodes at (here six), each captures
    once and every later batch of it replays, its inputs copied into the
    graph's buffers and its launches credited; a parameter replaced by a
    new tensor drops every graph.  The capture and the replay are
    stand-ins (no card)."""
    from svpc_torch.decode import greedy
    from svpc_torch.ops.attention import LAUNCHES

    class Replays:  # stands for a captured CUDA graph
        n = 0

        def replay(self):
            self.n += 1

    def capture(self, model, inputs, grid, key):
        static = {k: t.clone() for k, t in inputs.items()}
        self.entries[key] = greedy._Graph(
            Replays(), static, (static["ga_inputs"], static["ga_inputs"]),
            {"fused_attention": 3, "fused_attention.decode": 3})
        greedy.GRAPHS["captured"] += 1
        return "warm-up tokens"

    monkeypatch.setattr(greedy.DecodeGraphs, "_capture", capture)
    cfg, model = _model("video")
    inputs = _loop_inputs(model, _packed(cfg, 5))
    shapes = [{k: t[:n] for k, t in inputs.items()} for n in range(2, 14, 2)]
    graphs = greedy.decode_graphs(model)
    greedy.reset_graphs()
    for x in shapes:
        assert graphs.run(model, x, (len(x["ga_inputs"]), 1)) == \
            ("warm-up tokens", False)
    before = dict(LAUNCHES)
    for rnd in (1, 2):
        for x in shapes:
            fresh = {k: t + rnd for k, t in x.items()}
            (text_ids, _), replayed = graphs.run(
                model, fresh, (len(x["ga_inputs"]), 1))
            assert replayed and torch.equal(text_ids, fresh["ga_inputs"])
    assert greedy.GRAPHS == {"captured": 6, "replayed": 12, "eager": 0}
    assert len(graphs.entries) == 6
    assert all(e.graph.n == 2 for e in graphs.entries.values())
    assert LAUNCHES["fused_attention"] - before["fused_attention"] == 36
    assert (LAUNCHES["fused_attention.decode"]
            - before["fused_attention.decode"]) == 36

    ln = model.decoder.layer[0].norm1
    ln.weight = torch.nn.Parameter(ln.weight.detach().clone())
    assert graphs.run(model, shapes[0], (2, 1)) == ("warm-up tokens", False)
    assert len(graphs.entries) == 1 and greedy.GRAPHS["captured"] == 7


def test_serving_stats_count_graph_batches():
    from svpc_torch.serving import ServingStats

    stats = ServingStats()
    assert stats.snapshot()["decode_graph_batches"] == 0
    stats.record_batch(2, 5, [0.1, 0.2], graphed=True)
    stats.record_batch(1, 3, [0.1])
    snap = stats.snapshot()
    assert snap["batches"] == 2 and snap["decode_graph_batches"] == 1
    assert ServingStats().snapshot()["decode_graph_batches"] == 0


def test_cpu_service_reports_no_graph_batches(tmp_path):
    from svpc_torch.cli.serve import start_server, stop_server
    from svpc_torch.data.synthetic import write_serving_fixture
    from svpc_torch.serving import CaptionService

    cfg, model = _model("full")
    fx = write_serving_fixture(str(tmp_path), cfg, n_videos=2, min_clips=1,
                               max_clips=cfg.model.max_n_sen, seed=3)
    cfg = cfg.replace_data(
        word2idx_path=fx["word2idx_path"], verb2idx_path=fx["verb2idx_path"],
        duration_file=fx["duration_file"],
        video_feature_dir=fx["video_feature_dir"])
    server = start_server(CaptionService(cfg, model, batch_videos=2,
                                         device="cpu"),
                          port=0, max_wait_ms=5)
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        vid, spec = next(iter(fx["specs"].items()))
        req = urllib.request.Request(
            base + "/v1/captions", json.dumps(dict(spec, video_id=vid))
            .encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
        with urllib.request.urlopen(base + "/v1/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        stop_server(server)
    assert stats["batches"] == 1 and stats["decode_graph_batches"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["full", "video"])
def test_graph_tokens_equal_the_eager_loop(mode, dtype):
    """On the card: the first decode of a shape captures, later batches of
    that shape replay, and the replayed tokens equal the eager loop's on
    two different batches; a replay credits ``LAUNCHES`` with what an
    eager decode launches; the result is a new tensor each time; and a
    load in place (the trainer's EMA weights each epoch) reaches the graph
    without a new capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs this check)")
    from svpc_torch.decode import greedy
    from svpc_torch.ops.attention import LAUNCHES

    cfg, model = _model(mode, dtype)
    model = model.cuda()
    batches = [_packed(cfg, seed, "cuda") for seed in (5, 6)]
    greedy.reset_graphs()
    greedy.greedy_decode(model, batches[0])
    assert greedy.GRAPHS["captured"] == 1 and not greedy.replayed_last()

    def launched(batch, **kw):
        before = dict(LAUNCHES)
        out = greedy.greedy_decode(model, batch, **kw)
        torch.cuda.synchronize()
        return out, {k: LAUNCHES[k] - before[k] for k in LAUNCHES}

    for batch in batches + batches[::-1]:
        got, replay = launched(batch)
        assert greedy.replayed_last()
        want, eager = launched(batch, graph=False)
        assert torch.equal(got, want)
        assert replay == eager and eager["fused_attention.decode"] > 0
        got.fill_(-1)
    assert greedy.GRAPHS == {"captured": 1, "replayed": 4, "eager": 4}

    other = _model(mode, dtype, seed=1)[1]
    model.load_state_dict(other.state_dict())
    for batch in batches:
        got = greedy.greedy_decode(model, batch)
        assert greedy.replayed_last()
        assert torch.equal(got, greedy.greedy_decode(model, batch,
                                                     graph=False))
    assert greedy.GRAPHS["captured"] == 1

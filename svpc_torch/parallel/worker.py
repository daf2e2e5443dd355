"""Run the mesh path in separate processes and check it: the rank launcher
and the jobs a rank runs, for the CPU tests and for ``chip_smoke.py``.

    python -m svpc_torch.parallel.worker <job> <spec.json>

started once a rank by ``run_ranks`` (or by torchrun), each rank reading
torchrun's variables.  ``spec`` holds ``device`` ("cpu", or "cuda:0" to
put every rank on one card), ``backend`` (None: NCCL on a card, gloo on
the CPU), ``dp`` / ``tp`` / ``pp`` (the mesh; ``cfg.train``'s for
``train``) and ``out`` (a directory), and per job:

  steps    ``cfg`` (a Config dict), the whole initial weights (``weights``,
           a torch file of a state dict; else drawn from ``seed``),
           ``n_steps`` global batches (``batches``, a pickle of numpy
           batches; else the trainer's first batches of the ``cfg``'s
           train split, ``train_batches``), and optionally the re-simulator's
           Gumbel noise (``noise``, a pickle of one global array a step,
           which replaces the sampler's draw): ``train_step`` on this
           rank's block of each, the trunks pipelined when ``pp`` > 1
           (``cfg.train.pp_microbatches`` a call).  Rank 0 writes
           ``result.pt`` (the losses, the whole parameters, moments and
           EMA shadow); every rank writes ``rank<r>.json`` (its parameter
           count, bytes of its moments and shadow, and what they would be
           without ZeRO-1, its peak memory, its kernel launches).
  train    ``train.loop.train(cfg, out, ...)`` with ``max_steps_per_epoch``
           (a pp run when ``cfg.train.pp_size`` > 1); rank 0 writes
           ``result.json`` (the steps and the history) and, with
           ``record_forms``, ``forms.pt`` (the first inputs of each form
           of attention call the run made, validation's); every rank
           ``rank<r>.json`` (its kernel launches, their head counts, its
           seconds and peak memory).
  serve    a ``CaptionService`` on the dp x tp mesh from a trainer
           checkpoint (``checkpoint``; ``batch_videos``, ``max_clips``)
           for each ``(beam_size, n_best)`` of ``decoders``: rank 0
           captions ``specs`` ({vid: spec}) with ``caption`` and closes the
           service, the other ranks ``follow``.  Rank 0 writes
           ``result.json`` (the captions of each decoder); every rank
           writes ``rank<r>.json`` (kernel launches, the head counts its
           attention calls used).
  decode   a trainer checkpoint (``checkpoint``) greedily decodes the first
           ``split`` batch of ``val_batch_size`` videos on the mesh, every
           attention call recorded.  Rank 0 writes ``result.pt`` (the
           gathered tokens, the first inputs of each attention form);
           every rank writes ``rank<r>.json`` (kernel launches, the head
           counts its attention calls used).
  cli_serve
           ``svpc_torch.cli.serve.main(argv)`` (``argv``, with the mesh
           flags) on every rank, as torchrun would run the CLI; rank 0
           serves until SIGTERM.  Every rank writes ``rank<r>.json``
           (kernel launches and head counts from the end of the warm-up)
           and, with ``record_forms``, ``forms_rank<r>.pt`` (the first
           inputs of each attention form it ran after the warm-up).  With
           ``fail_rank``, that rank's fill of each batch raises.
  gpipe    the clip encoder's and the decoder's trunks of ``cfg`` at each
           depth of ``layers`` and each ``remat`` setting, with dropout
           on: the pipelined stage (parallel/pipeline.py) against the same
           trunk run sequentially in this process from the same weights
           and generator seed, the output and every gradient this stage
           holds (its layers', the input's, the encoder output's).  Every
           rank writes ``rank<r>.json`` (how far the worst element is
           outside rtol = atol = 1e-5, and whether every layer output,
           bubble ticks included, was finite).
  nccl     world size 1: the collectives of parallel/collectives.py on the
           device, forward and backward, and one dp1 x tp1 train step
           through the mesh path beside the same step without a mesh;
           writes ``result.json``.

Imports nothing of JAX: the CPU tests pass svpc_tpu's arrays in files.
"""

from __future__ import annotations

import copy
import json
import os
import pickle
import subprocess
import sys
import time
from typing import Dict, List, Optional

import torch

from svpc_torch.parallel.mesh import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------- #
# launcher
# ---------------------------------------------------------------------- #

class Ranks:
    """``python -m <args>`` once a rank, as torchrun starts them on one
    host (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, a free local
    ``MASTER_PORT``), from the repository root; each rank's output goes
    to ``<log_dir>/rank<r>.log``.  ``wait`` returns when every rank has
    exited; every rank is killed at the timeout or when one fails, and it
    raises with the logs' tails then (a server's ranks: ``wait`` after
    shutting rank 0 down)."""

    def __init__(self, args: List[str], world: int, log_dir: str,
                 env: Optional[Dict[str, str]] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.args, self.world, self.log_dir = args, world, log_dir
        base = dict(os.environ, MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
                    **(env or {}))
        self.logs = [open(os.path.join(log_dir, f"rank{r}.log"), "w")
                     for r in range(world)]
        self.t0 = time.perf_counter()
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", *args], cwd=ROOT, stdout=self.logs[r],
            stderr=subprocess.STDOUT,
            env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
            for r in range(world)]

    def failed(self) -> Optional[str]:
        """Why a rank failed so far, or None."""
        bad = [r for r, p in enumerate(self.procs)
               if p.poll() not in (None, 0)]
        if bad:
            return f"rank {bad[0]} exited {self.procs[bad[0]].returncode}"
        return None

    def wait(self, timeout: float) -> float:
        """Wait for every rank (``timeout`` seconds from the start); the
        wall seconds since the start."""
        failed = None
        try:
            while any(p.poll() is None for p in self.procs):
                if time.perf_counter() - self.t0 > timeout:
                    failed = f"timed out after {timeout:.0f} s"
                    break
                failed = self.failed()
                if failed:
                    break
                time.sleep(0.05)
            failed = failed or self.failed()
        finally:
            self.kill()
        if failed:
            raise RuntimeError(f"{' '.join(self.args[:2])}: {failed}\n"
                               + self.tails())
        return time.perf_counter() - self.t0

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in self.logs:
            f.close()

    def tails(self) -> str:
        out = []
        for r in range(self.world):
            with open(os.path.join(self.log_dir, f"rank{r}.log")) as f:
                out.append(f"--- rank {r} ---\n" + f.read()[-3000:])
        return "\n".join(out)


def run_ranks(args: List[str], world: int, timeout: float, log_dir: str,
              env: Optional[Dict[str, str]] = None) -> float:
    """``Ranks(args, world, log_dir, env).wait(timeout)``: the wall
    seconds; raises when a rank fails or the timeout passes."""
    return Ranks(args, world, log_dir, env).wait(timeout)


def run_job(job: str, spec: dict, world: int, timeout: float,
            env: Optional[Dict[str, str]] = None) -> float:
    """One of this module's jobs on ``world`` ranks (``spec`` is written
    to ``<spec["out"]>/spec.json``)."""
    os.makedirs(spec["out"], exist_ok=True)
    path = os.path.join(spec["out"], "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return run_ranks(["svpc_torch.parallel.worker", job, path], world,
                     timeout, spec["out"], env)


# ---------------------------------------------------------------------- #
# shared by the jobs and by the one-process runs they are held against
# ---------------------------------------------------------------------- #

def train_batches(cfg, n: int, dp: int = 1) -> list:
    """The first ``n`` host batches of the trainer's first epoch on the
    train split (shuffled from the seed, packed in ``dp`` blocks as the
    trainer packs them on a dp mesh)."""
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.train.loop import packing_builder

    ds = CaptionDataset(cfg, "train", lazy_features=True)
    it = ds.batches(cfg.train.batch_size, shuffle=True,
                    seed=cfg.train.seed, length_group=cfg.train.length_group,
                    builder=packing_builder(cfg, dp_shards=dp))
    return [b for b, _ in (next(it) for _ in range(n))]


def train_state(cfg, model, steps_per_epoch: int, mesh=None):
    """A TrainState over ``model`` (already sharded on ``mesh``), with
    ZeRO-1 as ``cfg.train.zero1`` asks."""
    from svpc_torch.parallel.mesh import zero1_dims
    from svpc_torch.train.optim import make_optimizer
    from svpc_torch.train.state import TrainState

    opt = make_optimizer(
        cfg.train, steps_per_epoch, dict(model.named_parameters()),
        mesh=mesh, tp_split=model.param_tp_dims,
        zero1_split=(zero1_dims(model.full_shapes, mesh)
                     if cfg.train.zero1 and mesh is not None else None))
    return TrainState.create(model, opt, use_ema=cfg.train.ema_decay > 0,
                             ema_dtype=cfg.train.optimizer_dtype)


class NoisePatch:
    """Replaces the re-simulator's Gumbel draw with this rank's block of
    a given global noise array (``noise`` None: the sampler's own draw)."""

    def __init__(self, noise, mesh=None):
        self.noise, self.mesh = noise, mesh

    def __enter__(self):
        import svpc_torch.model.svpc as svpc
        from svpc_torch.ops.gumbel import straight_through

        self.real = svpc.gumbel_softmax_st
        if self.noise is None:
            return self

        def shared(logits, tau, generator=None):
            g = torch.from_numpy(self.noise)
            if self.mesh is not None:
                n = logits.shape[0]
                g = g[self.mesh.dp_index * n:(self.mesh.dp_index + 1) * n]
            return straight_through(logits, g.to(logits.device), tau)

        svpc.gumbel_softmax_st = shared
        return self

    def __exit__(self, *exc):
        import svpc_torch.model.svpc as svpc
        svpc.gumbel_softmax_st = self.real


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _rank_file(spec, mesh, row: dict) -> None:
    with open(os.path.join(spec["out"], f"rank{mesh.rank}.json"), "w") as f:
        json.dump(dict(row, dp_index=mesh.dp_index, tp_index=mesh.tp_index,
                       pp_index=mesh.pp_index), f)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------- #
# jobs
# ---------------------------------------------------------------------- #

def job_steps(spec, mesh, device) -> None:
    from svpc_torch.config import Config
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.ops.attention import LAUNCHES, reset_launches
    from svpc_torch.parallel.mesh import shard_batch
    from svpc_torch.train.step import train_step

    cfg = Config.from_dict(spec["cfg"])
    if spec.get("weights"):
        model = SVPCModel(cfg.model)
        model.load_state_dict(torch.load(spec["weights"], weights_only=True),
                              strict=True)
    else:
        model = SVPCModel(cfg.model,
                          torch.Generator().manual_seed(spec["seed"]))
    model = model.shard(mesh, pp_microbatches=cfg.train.pp_microbatches
                        ).to(device)
    state = train_state(cfg, model, spec["steps_per_epoch"], mesh)
    reset_launches()
    if spec.get("batches"):
        with open(spec["batches"], "rb") as f:
            batches = pickle.load(f)
    else:
        batches = train_batches(cfg, spec["n_steps"], mesh.dp_size)
    noise = [None] * len(batches)
    if spec.get("noise"):
        with open(spec["noise"], "rb") as f:
            noise = pickle.load(f)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    losses = []
    for batch, g in zip(batches, noise):
        with NoisePatch(g, mesh):
            m = train_step(state, to_tensors(shard_batch(mesh, batch),
                                             device), cfg)
        losses.append({k: float(m[k]) for k in
                       ("loss", "caption_loss", "grad_norm")})
    opt = state.optimizer
    held = {"m": _nbytes(opt.m.values()), "v": _nbytes(opt.v.values()),
            "ema": _nbytes((state.ema_shadow or {}).values())}
    # the same state without ZeRO-1: every tp-local tensor whole
    item = {"m": next(iter(opt.m.values())).element_size(),
            "ema": (next(iter(state.ema_shadow.values())).element_size()
                    if state.ema_shadow else 0)}
    local = sum(p.numel() for p in state.params.values())
    whole = {"m": local * item["m"], "v": local * item["m"],
             "ema": local * item["ema"]}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    payload = state.state_dict()
    if mesh.is_main:
        torch.save({"losses": losses, "state": _cpu(payload)},
                   os.path.join(spec["out"], "result.pt"))
    _rank_file(spec, mesh, {"n_params": local, "bytes": held,
                            "bytes_without_zero1": whole,
                            "max_memory_allocated": peak,
                            "losses": losses, "launches": dict(LAUNCHES)})


def job_train(spec, mesh, device) -> None:
    import svpc_torch.train.loop as loop
    from svpc_torch.config import Config
    from svpc_torch.ops.attention import LAUNCHES, reset_launches

    cfg = Config.from_dict(spec["cfg"])
    reset_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with FormRecorder(keep=spec.get("record_forms", False)) as rec:
        res = loop.train(cfg, spec["out"], device=device,
                         max_steps_per_epoch=spec.get("max_steps_per_epoch"),
                         eval_language=spec.get("eval_language", True),
                         tensorboard=False)
    mesh = res["state"].mesh
    if mesh.is_main:
        with open(os.path.join(spec["out"], "result.json"), "w") as f:
            json.dump({"steps": res["steps"], "history": res["history"]}, f)
        if rec.keep:
            torch.save(rec.form_list(),
                       os.path.join(spec["out"], "forms.pt"))
    _rank_file(spec, mesh, {
        "launches": dict(LAUNCHES), "heads": rec.heads,
        "train_s": time.perf_counter() - t0,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None)})


def job_decode(spec, mesh, device) -> None:
    from svpc_torch.config import Config
    from svpc_torch.data.pipeline import CaptionDataset
    from svpc_torch.model import SVPCModel
    from svpc_torch.ops.attention import LAUNCHES, reset_launches
    from svpc_torch.train.loop import _decode_batches, make_eval_decoder
    from svpc_torch.train.state import load_eval_weights

    ckpt = spec["checkpoint"]
    cfg = Config.from_json(ckpt + ".cfg.json").replace_train(
        val_batch_size=spec["val_batch_size"], dp_size=mesh.dp_size,
        tp_size=mesh.tp_size)
    model = SVPCModel(cfg.model)
    model.load_state_dict(load_eval_weights(ckpt), strict=True)
    model = model.shard(mesh).to(device).eval()
    ds = CaptionDataset(cfg, spec.get("split", "val"), lazy_features=True)
    decoder = make_eval_decoder(model, cfg, ds)
    with FormRecorder(keep=True) as rec:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        reset_launches()
        tokens, _ = next(_decode_batches(ds, decoder, max_batches=1))
        launches = dict(LAUNCHES)
    heads = rec.heads
    if mesh.is_main:
        torch.save({"tokens": tokens.cpu(), "forms": rec.form_list()},
                   os.path.join(spec["out"], "result.pt"))
    _rank_file(spec, mesh, {"launches": launches, "heads": heads})


class FormRecorder:
    """While entered, counts the attention calls of ``model/layers.py``
    by head count and, with ``keep``, by form (sequences, query and key
    lengths, mask shape), keeping each form's first inputs on the CPU."""

    def __init__(self, keep: bool = False):
        self.keep = keep
        self.heads: Dict[str, int] = {}
        self.forms: dict = {}

    def reset(self) -> None:
        self.heads.clear()
        self.forms.clear()

    def __enter__(self):
        import svpc_torch.model.layers as layers
        self.real = layers.fused_attention

        def recording(q, k, v, mask, nh):
            self.heads[str(nh)] = self.heads.get(str(nh), 0) + 1
            if self.keep:
                key = (q.shape[0], q.shape[1], k.shape[1],
                       tuple(mask.shape[1:]))
                if key not in self.forms:
                    self.forms[key] = {
                        "inputs": [t.detach().cpu() for t in (q, k, v, mask)],
                        "num_heads": nh, "calls": 0}
                self.forms[key]["calls"] += 1
            return self.real(q, k, v, mask, nh)

        layers.fused_attention = recording
        return self

    def __exit__(self, *exc):
        import svpc_torch.model.layers as layers
        layers.fused_attention = self.real

    def form_list(self) -> list:
        return [dict(v, key=list(k)) for k, v in self.forms.items()]


def job_serve(spec, mesh, device) -> None:
    from svpc_torch.config import Config
    from svpc_torch.model import SVPCModel
    from svpc_torch.ops.attention import LAUNCHES, reset_launches
    from svpc_torch.serving import CaptionService
    from svpc_torch.train.state import load_eval_weights

    ckpt = spec["checkpoint"]
    cfg = Config.from_json(ckpt + ".cfg.json")
    weights = load_eval_weights(ckpt)
    results = []
    reset_launches()
    with FormRecorder() as counter:
        for beam_size, n_best in spec["decoders"]:
            model = SVPCModel(cfg.model)
            model.load_state_dict(weights, strict=True)
            service = CaptionService(
                cfg, model, batch_videos=spec["batch_videos"],
                max_clips=spec.get("max_clips"), beam_size=beam_size,
                n_best=n_best, mesh=mesh, device=device, warmup=False)
            if not mesh.is_main:
                service.follow()
                continue
            try:
                results.append(service.caption(spec["specs"]))
            finally:
                service.close()
    if mesh.is_main:
        with open(os.path.join(spec["out"], "result.json"), "w") as f:
            json.dump(results, f)
    _rank_file(spec, mesh, {"launches": dict(LAUNCHES),
                            "heads": counter.heads})


def job_cli_serve(spec, mesh, device) -> None:
    """``svpc_torch.cli.serve.main(spec["argv"])`` on this rank, its
    attention calls counted (with ``record_forms``, recorded by form) from
    the end of the service's warm-up, with the kernel launches and the
    decode graph counters (a replayed decode calls no attention in
    Python); with ``fail_rank``, that rank's fill of every announced
    batch raises."""
    from svpc_torch.cli import serve
    from svpc_torch.decode.greedy import GRAPHS, reset_graphs
    from svpc_torch.ops.attention import LAUNCHES, reset_launches
    from svpc_torch.serving import CaptionService

    rank = int(os.environ.get("RANK", 0))
    real = CaptionService.warmup, CaptionService._examples_from
    with FormRecorder(keep=spec.get("record_forms", False)) as rec:
        def warmup(service):
            real[0](service)
            reset_launches()
            reset_graphs()
            rec.reset()

        def examples_from(service, entries):
            raise RuntimeError(f"rank {rank}: injected fill failure")

        CaptionService.warmup = warmup
        if spec.get("fail_rank") == rank:
            CaptionService._examples_from = examples_from
        try:
            serve.main(spec["argv"])
        finally:
            CaptionService.warmup, CaptionService._examples_from = real
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump({"launches": dict(LAUNCHES), "heads": rec.heads,
                   "decode_graphs": dict(GRAPHS)}, f)
    if rec.keep:
        torch.save(rec.form_list(),
                   os.path.join(spec["out"], f"forms_rank{rank}.pt"))


def job_gpipe(spec, mesh, device) -> None:
    from svpc_torch.config import Config
    from svpc_torch.model.layers import (Decoder, Encoder, StageLayers,
                                         _Pipelined)
    from svpc_torch.model.svpc import init_parameters
    from svpc_torch.parallel.mesh import GlobalDraws, stage_layers

    base = Config.from_dict(spec["cfg"]).model
    gen = torch.Generator().manual_seed(spec["seed"])
    n, lq, lk, h = 8, 6, 3, base.hidden_size
    rows = []
    for depth in spec["layers"]:
        for remat in (False, True):
            cfg = base.__class__(**{**base.__dict__, "num_hidden_layers":
                                    depth, "remat": remat})
            for kind in ("encoder", "decoder"):
                whole = (Encoder if kind == "encoder" else Decoder)(cfg)
                init_parameters(whole, 0.05, gen)
                x = torch.randn(n, lq, h, generator=gen)
                mask = (torch.rand(n, lq, generator=gen) > 0.2).float()
                mask[:, 0] = 1.0
                enc = torch.randn(n, lk, h, generator=gen)
                weight = torch.randn(n, lq, h, generator=gen)
                staged = copy.deepcopy(whole)
                staged.layer = StageLayers(staged.layer,
                                           stage_layers(depth, mesh))
                staged.pipelined = _Pipelined(mesh, 0)
                finite = []
                for layer in staged.layer:
                    layer.register_forward_hook(
                        lambda m, i, o: finite.append(
                            bool(torch.isfinite(o).all())))
                out = {}
                for name, trunk in (("sequential", whole),
                                    ("pipelined", staged)):
                    xi = x.clone().requires_grad_(True)
                    ei = enc.clone().requires_grad_(True)
                    g = GlobalDraws(torch.Generator().manual_seed(
                        spec["seed"] + depth), mesh)
                    if kind == "encoder":
                        y = trunk(xi, mask, False, False, g)
                    else:
                        y = trunk(xi, mask, ei, torch.ones(n, lk), False, g)
                    (y * weight).sum().backward()
                    out[name] = {"y": y.detach(), "x": xi.grad,
                                 "enc": ei.grad,
                                 **{k: p.grad for k, p in
                                    trunk.named_parameters()}}
                pip, seq = out["pipelined"], out["sequential"]
                # max(|diff| - 1e-5 - 1e-5 |sequential|): <= 0 when every
                # element is within rtol = atol = 1e-5
                err = {k: float(((v - seq[k]).abs() - 1e-5
                                 - 1e-5 * seq[k].abs()).max())
                       for k, v in pip.items() if v is not None}
                rows.append({"layers": depth, "remat": remat, "trunk": kind,
                             "tol_excess": max(err.values()),
                             "worst": max(err, key=err.get),
                             "grads": len(err) - 1,
                             "finite": all(finite),
                             "layer_calls": len(finite)})
    _rank_file(spec, mesh, {"cases": rows})


def job_nccl(spec, mesh, device) -> None:
    """World size 1 on NCCL: each collective's forward and backward on the
    device, then one train step on the dp1 x tp1 mesh beside the same
    step without one."""
    from svpc_torch.config import Config
    from svpc_torch.model import SVPCModel
    from svpc_torch.model.svpc import to_tensors
    from svpc_torch.parallel import collectives as C
    from svpc_torch.parallel.mesh import shard_batch
    from svpc_torch.train.step import train_step

    checks = {}
    x = torch.randn(4, 6, device=device, requires_grad=True)
    for name, fn, group in (("copy_to_tp", C.copy_to_tp, mesh.tp_group),
                            ("reduce_from_tp", C.reduce_from_tp,
                             mesh.tp_group),
                            ("gather_from_tp", C.gather_from_tp,
                             mesh.tp_group),
                            ("all_reduce_dp", C.all_reduce_dp,
                             mesh.dp_group)):
        y = fn(x, group)
        (grad,) = torch.autograd.grad((y * 2.0).sum(), x)
        checks[name] = bool(torch.equal(y, x) and
                            torch.equal(grad, torch.full_like(x, 2.0)))
    checks["gather_dim"] = bool(torch.equal(
        C.gather_dim(x, 0, mesh.dp_group), x.detach()))

    cfg = Config.from_dict(spec["cfg"])
    batch = train_batches(cfg, 1)[0]
    losses = {}
    for name, m in (("mesh", mesh), ("plain", None)):
        model = SVPCModel(cfg.model,
                          torch.Generator().manual_seed(spec["seed"]))
        model = model.shard(m).to(device)
        state = train_state(cfg, model, 1, m)
        b = batch if m is None else shard_batch(m, batch)
        out = train_step(state, to_tensors(b, device), cfg)
        losses[name] = {k: float(out[k]) for k in ("loss", "grad_norm")}
    with open(os.path.join(spec["out"], "result.json"), "w") as f:
        json.dump({"collectives": checks, "train_step": losses,
                   "backend": torch.distributed.get_backend(),
                   "device": str(device)}, f)


JOBS = {"steps": job_steps, "train": job_train, "decode": job_decode,
        "serve": job_serve, "cli_serve": job_cli_serve, "gpipe": job_gpipe,
        "nccl": job_nccl}


def main(argv=None) -> None:
    from svpc_torch.parallel.mesh import (close_distributed,
                                          init_distributed, make_mesh,
                                          rank_device)

    job, path = (argv or sys.argv[1:])[:2]
    with open(path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec.get("threads", 1))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = rank_device(spec.get("device"))
    init_distributed(spec.get("backend"), device,
                     timeout_s=spec.get("timeout_s", 120))
    # the trainer and the serving CLI make their own mesh from their flags
    mesh = (None if job in ("train", "cli_serve")
            else make_mesh(spec.get("dp", 1), spec.get("tp", 1),
                           spec.get("pp", 1)))
    try:
        JOBS[job](copy.deepcopy(spec), mesh, device)
    finally:
        close_distributed()


if __name__ == "__main__":
    main()

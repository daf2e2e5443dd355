"""Caption serving daemon: HTTP front-end over the dynamic batcher.

The port of svpc_tpu/cli/serve.py.  It loads a checkpoint of the port's
trainer (``cli.train``'s ``checkpoint_best``: its sidecar's configuration
and EMA weights) or, with ``--torch_checkpoint``, a reference-format
PyTorch ``.chkpt`` (the JAX package's orbax checkpoints need JAX and are
refused), warms the decoder at one fixed geometry on the card, and answers
concurrent single-video requests with dynamic batching
(svpc_torch/serving.py).  ``--use_beam --beam_size K`` decodes by beam
search; ``--n_best N`` adds the N ranked hypotheses to every caption.

    python -m svpc_torch.cli.serve --model_type vivt \
        --checkpoint run/checkpoint_best \
        --word2idx_path word2idx.json --verb2idx_path verb2idx.json \
        --video_feature_dir features --duration_file durations.csv \
        --port 8700 --batch_videos 8 --max_wait_ms 25

API (JSON over HTTP):

  POST /v1/captions
      {"video_id": "...", "timestamps": [[start_s, end_s], ...],
       "ingredients": ["olive oil", ...]}
   -> {"video_id": "...",
       "captions": [{"timestamp": [s, e], "sentence": "..."} ...]}
      (features are read from --video_feature_dir/<vid>_{resnet,bn}.npy;
       the duration CSV must carry a row per video; with --use_beam
       --n_best N each caption also carries "nbest": ranked
       [{"sentence", "score"}, ...]; with --upload_dir a request may
       carry the features inline instead: "features": {"resnet": <base64
       .npy>, "bn": <base64 .npy>} plus the video's "duration" (s) and
       "n_frames", spooled as float32 files; svpc_torch.client.
       CaptionClient sends them)
  GET /healthz     -> {"status": "ok", ...model/serving geometry...}
  GET /v1/stats    -> request/batch counters (``decode_graph_batches``:
                      batches whose greedy decode replayed a CUDA graph)
                      + latency quantiles, and the decoder ("greedy" or
                      "beam{K}") with its n_best

Errors: 400 (bad spec / unknown video), 411 (chunked body), 502 (device
batch failed), 503 (decode timeout), 500.

On a dp x tp mesh (svpc_tpu's ``--dp_size`` / ``--tp_size``)::

    torchrun --nproc_per_node D*T -m svpc_torch.cli.serve ... \
        --dp_size D --tp_size T

each rank holds its tp shards and decodes its dp block of every batch
(``--batch_videos`` must be a multiple of D); rank 0 listens and batches,
the other ranks follow it (svpc_torch/serving.py) and exit when it shuts
down.  When a batch's collectives fail (a follower died, say) the ranks
are out of step: rank 0 answers that batch 502, stops listening and exits
non-zero, so a supervisor sees it go.  ``--pp_size`` > 1 is refused, as
svpc_tpu refuses it.
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from svpc_torch.cli.common import (add_common_args, add_mesh_args,
                                   config_from_args, load_checkpoint_model,
                                   reject_pp)
from svpc_torch.serving import (CaptionService, DecodeFailure, DecodeTimeout,
                                DynamicBatcher, ServingError)
from svpc_torch.train.loop import mesh_for

logger = logging.getLogger(__name__)


class CaptionHandler(BaseHTTPRequestHandler):
    """One handler per connection (ThreadingHTTPServer); the service and
    batcher hang off the server object."""

    protocol_version = "HTTP/1.1"
    # bounds a silent/stalled client: no single socket read or write can
    # block a handler (or a drain) for more than this
    timeout = 30

    def log_message(self, fmt, *fmt_args):  # route to logging, not stderr
        logger.debug("%s - %s", self.address_string(), fmt % fmt_args)

    def _tracked(self, inner):
        """Bracket one request in the server's in-flight counter so a
        drain can wait (bounded) for requests mid-decode or mid-write, and
        end keep-alive connections once draining starts."""
        srv = self.server
        with srv.inflight_lock:
            srv.inflight += 1
        try:
            inner()
        finally:
            if srv.draining.is_set():
                self.close_connection = True
            with srv.inflight_lock:
                srv.inflight -= 1
                srv.inflight_zero.notify_all()

    def do_GET(self):
        self._tracked(self._do_get)

    def do_POST(self):
        self._tracked(self._do_post)

    def _reply(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _do_get(self):
        srv = self.server
        if self.path == "/healthz":
            svc = srv.service
            if svc.broken.is_set():  # the mesh failed; shutting down
                self._reply(503, {"status": "broken"})
                return
            self._reply(200, {
                "status": "ok",
                "model_mode": svc.cfg.model.model_mode,
                "decoder": svc.decoder,
                "n_best": svc.n_best,
                "batch_videos": svc.batch_videos,
                "max_clips": svc.max_clips,
                "compute_dtype": svc.cfg.model.compute_dtype,
                "device": str(svc.device),
            })
        elif self.path == "/v1/stats":
            self._reply(200, dict(srv.batcher.stats.snapshot(),
                                  decoder=srv.service.decoder,
                                  n_best=srv.service.n_best))
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def _do_post(self):
        srv = self.server
        # always drain the body first: an early error reply would leave
        # the unread bytes to be parsed as the next keep-alive request
        if self.headers.get("Transfer-Encoding"):
            self.close_connection = True
            srv.batcher.stats.record_error()
            self._reply(411, {"error": "chunked/transfer-encoded bodies "
                                       "unsupported; send Content-Length"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0) or 0)
        except ValueError:
            length = -1
        if not 0 <= length <= srv.max_request_bytes:
            self.close_connection = True
            srv.batcher.stats.record_error()
            self._reply(400, {"error": "bad Content-Length header "
                                       f"(0..{srv.max_request_bytes})"})
            return
        body = self.rfile.read(length)
        if self.path != "/v1/captions":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            req = json.loads(body or b"{}")
            if not isinstance(req, dict):
                raise ServingError("request body must be a JSON object")
            video_id = req.get("video_id")
            if not video_id:
                raise ServingError("request needs a 'video_id'")
            entry = srv.service.make_entry(video_id, req)
            payloads = srv.batcher.submit(entry,
                                          timeout=srv.request_timeout)
            resp = {
                "video_id": video_id,
                "captions": [dict({"timestamp": entry["timestamps"][i]},
                                  **c)
                             for i, c in enumerate(payloads)],
            }
            n_asked = len(req.get("timestamps") or [])
            if n_asked > len(entry["timestamps"]):
                resp["truncated_clips"] = n_asked - len(entry["timestamps"])
            self._reply(200, resp)
        except DecodeFailure as e:  # counted by the batcher worker
            self._reply(502, {"error": str(e)})
        except DecodeTimeout as e:  # submit() already recorded it
            self._reply(503, {"error": str(e)})
        except TimeoutError:
            # the client's socket stalled mid-reply: nothing more can be
            # sent, so let handle_one_request close the connection
            logger.warning("client stalled mid-reply; dropping connection")
            raise
        except (ServingError, ValueError) as e:  # JSONDecodeError included
            srv.batcher.stats.record_error()
            self._reply(400, {"error": str(e)})
        except Exception as e:  # keep the daemon alive
            logger.exception("request failed")
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


class CaptionHTTPServer(ThreadingHTTPServer):
    # daemon handler threads: the process can always exit; drain() waits
    # (bounded) for in-flight requests instead
    daemon_threads = True

    def __init__(self, addr, service: CaptionService,
                 batcher: DynamicBatcher, request_timeout: float = 60.0):
        super().__init__(addr, CaptionHandler)
        self.service = service
        # feature uploads are the big payloads (a 2h video's f32 resnet+bn
        # pair is ~180 MB, ~240 MB base64'd); a daemon that takes none
        # keeps the 1 MiB bound of a disk-only request
        self.max_request_bytes = (1 << 30 if service.up_ds is not None
                                  else 1 << 20)
        self.batcher = batcher
        self.request_timeout = request_timeout
        self.draining = threading.Event()
        self.inflight = 0
        self.inflight_lock = threading.Lock()
        self.inflight_zero = threading.Condition(self.inflight_lock)

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop keep-alive reuse and wait (bounded) for in-flight
        requests to finish; True if the server went quiet in time."""
        self.draining.set()
        deadline = time.monotonic() + timeout
        with self.inflight_lock:
            while self.inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self.inflight_zero.wait(remaining)
            return True


def start_server(service: CaptionService, host: str = "127.0.0.1",
                 port: int = 0, max_wait_ms: float = 25.0,
                 request_timeout: float = 60.0) -> CaptionHTTPServer:
    """Build batcher + HTTP server and serve on a background thread;
    returns the server (its .server_address carries the bound port)."""
    batcher = DynamicBatcher(service, max_wait_ms=max_wait_ms)
    server = CaptionHTTPServer((host, port), service, batcher,
                               request_timeout)
    threading.Thread(target=server.serve_forever, name="svpc-http",
                     daemon=True).start()
    return server


def stop_server(server: CaptionHTTPServer, drain_timeout: float = 30.0
                ) -> None:
    server.shutdown()  # stop accepting new connections
    if not server.drain(drain_timeout):
        logger.warning("drain timed out with %d request(s) still in "
                       "flight; closing anyway", server.inflight)
    server.server_close()
    server.batcher.close()


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    add_common_args(p)
    add_mesh_args(p)
    p.add_argument("--checkpoint", required=True,
                   help="a checkpoint of svpc_torch.cli.train (e.g. "
                        "<workdir>/checkpoint_best)")
    p.add_argument("--torch_checkpoint", action="store_true",
                   help="--checkpoint is a reference PyTorch .chkpt file")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8700)
    p.add_argument("--batch_videos", type=int, default=8,
                   help="video slots per decode batch (the dynamic-batching "
                        "ceiling)")
    p.add_argument("--max_clips", type=int, default=0,
                   help="clip slots per video (default: max_n_sen)")
    p.add_argument("--max_wait_ms", type=float, default=25.0,
                   help="how long the first request of a batch waits for "
                        "company before decoding")
    p.add_argument("--clip_buckets", default="",
                   help="comma-separated packed clip budgets below the "
                        "worst case (e.g. 16,32): light batches ride a "
                        "smaller shape")
    p.add_argument("--upload_dir", default="",
                   help="enable inline feature upload: requests may carry "
                        "base64 .npy 'features' (+ duration/n_frames) "
                        "spooled into this directory")
    p.add_argument("--request_timeout", type=float, default=60.0)
    p.add_argument("--use_beam", action="store_true")
    p.add_argument("--beam_size", type=int, default=2)
    p.add_argument("--n_best", type=int, default=1,
                   help="with --use_beam: each caption also carries the "
                        "top-N ranked hypotheses with scores ('nbest'), "
                        "as cli.evaluate's --n_best submission does")
    return p


def build_service(argv=None):
    """Parse the daemon's flags, load the checkpoint and warm a
    CaptionService -> (service, args); on a mesh (every rank calls it)
    the service's ``mesh`` says which rank leads."""
    p = _parser()
    args = p.parse_args(argv)
    reject_pp(args, p)
    if args.n_best > 1 and not args.use_beam:
        p.error("--n_best > 1 requires --use_beam (greedy decode yields "
                "a single hypothesis)")
    if args.use_beam and args.n_best > args.beam_size:
        p.error(f"--n_best {args.n_best} cannot exceed "
                f"--beam_size {args.beam_size}")
    cfg = config_from_args(args)
    mesh = mesh_for(cfg, args.device)
    cfg, model = load_checkpoint_model(cfg, args)
    buckets = ([int(b) for b in args.clip_buckets.split(",")]
               if args.clip_buckets else None)
    service = CaptionService(cfg, model, batch_videos=args.batch_videos,
                             max_clips=args.max_clips or None,
                             beam_size=args.beam_size if args.use_beam else 0,
                             n_best=args.n_best if args.use_beam else 1,
                             clip_buckets=buckets,
                             upload_dir=args.upload_dir or None,
                             mesh=mesh, device=args.device)
    return service, args


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-10s: %(message)s")
    service, args = build_service(argv)
    if service.mesh is not None and not service.mesh.is_main:
        service.follow()  # until rank 0 shuts down
        return
    server = start_server(service, args.host, args.port,
                          max_wait_ms=args.max_wait_ms,
                          request_timeout=args.request_timeout)
    host, port = server.server_address[:2]
    logger.info("serving on http://%s:%d (POST /v1/captions)", host, port)
    # SIGTERM drains like Ctrl-C: stop accepting, finish in-flight
    # batches, then exit
    stop_requested = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop_requested.set())
    try:
        while not (stop_requested.wait(timeout=1.0)
                   or service.broken.is_set()):
            pass
        if stop_requested.is_set():
            logger.info("SIGTERM: draining and shutting down")
    except KeyboardInterrupt:
        logger.info("shutting down")
    finally:
        stop_server(server)
        service.close()
    if service.broken.is_set():
        raise SystemExit("svpc_torch.cli.serve: the mesh failed; its ranks "
                         "are out of step")


if __name__ == "__main__":
    from svpc_torch.parallel.mesh import close_distributed

    main()
    close_distributed()

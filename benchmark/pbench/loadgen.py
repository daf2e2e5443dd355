"""The load generator: a process of its own that imports only the standard
library, so that it takes no part of the server's interpreter lock.

It reads one JSON line on standard input: ``host``, ``port``, ``cores``
(the CPU cores it keeps to, or null), ``bodies``
(the request bodies of the video pool), ``sequence`` (pool indices, the
order requests are made in), ``loop`` ("closed": ``clients`` clients each
sending its next request when the last returns; "open": request k due at
``offsets[k]`` seconds, whatever is in flight), ``warmup`` (requests sent
closed-loop before the window, not recorded), ``seconds`` and
``timeout_s``.  After the warm-up it prints ``WARM`` and waits for a line
``GO <t0>``: the window is [t0, t0 + seconds] on the monotonic clock,
which the server's process shares.  It sends no request due after the
window, waits for every request sent, and prints one JSON line: each
request as [pool index, due, sent, done, HTTP status, clips captioned].
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import sys
import threading
import time


class Client:
    def __init__(self, host: str, port: int, timeout: float):
        self.host, self.port, self.timeout = host, port, timeout
        self.conn = None

    def post(self, body: bytes):
        """-> (status, clips captioned); a broken connection is opened
        again once."""
        for attempt in (0, 1):
            try:
                if self.conn is None:
                    self.conn = http.client.HTTPConnection(
                        self.host, self.port, timeout=self.timeout)
                self.conn.request("POST", "/v1/captions", body,
                                  {"Content-Type": "application/json"})
                resp = self.conn.getresponse()
                data = resp.read()
                clips = (len(json.loads(data)["captions"])
                         if resp.status == 200 else 0)
                return resp.status, clips
            except (OSError, http.client.HTTPException):
                self.conn = None
                if attempt:
                    return 0, 0
        return 0, 0


def closed_loop(cfg, bodies, sequence, start: int, count, t0, t_end,
                record):
    """``clients`` threads take the next request of ``sequence`` (from
    ``start``) until ``count`` are sent or the clock passes ``t_end``."""
    lock = threading.Lock()
    nxt = [start]

    def client():
        c = Client(cfg["host"], cfg["port"], cfg["timeout_s"])
        while True:
            with lock:
                k = nxt[0]
                if k - start >= count or time.monotonic() >= t_end:
                    return
                nxt[0] += 1
            idx = sequence[k % len(sequence)]
            due = time.monotonic()
            status, clips = c.post(bodies[idx])
            record(idx, due, due, time.monotonic(), status, clips)

    time.sleep(max(0.0, t0 - time.monotonic()))
    threads = [threading.Thread(target=client)
               for _ in range(cfg["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def open_loop(cfg, bodies, sequence, t0, record):
    """Request k due at t0 + offsets[k]; a pool of senders takes them as
    they fall due, so a slow reply delays no later request unless every
    sender is busy (then the lateness shows as sent - due)."""
    todo: queue.Queue = queue.Queue()

    def sender():
        c = Client(cfg["host"], cfg["port"], cfg["timeout_s"])
        while True:
            item = todo.get()
            if item is None:
                return
            k, due = item
            sent = time.monotonic()
            status, clips = c.post(bodies[sequence[k % len(sequence)]])
            record(sequence[k % len(sequence)], due, sent, time.monotonic(),
                   status, clips)

    threads = [threading.Thread(target=sender)
               for _ in range(cfg["senders"])]
    for t in threads:
        t.start()
    for k, off in enumerate(cfg["offsets"]):
        if off >= cfg["seconds"]:
            break
        due = t0 + off
        time.sleep(max(0.0, due - time.monotonic()))
        todo.put((k, due))
    for _ in threads:
        todo.put(None)
    for t in threads:
        t.join()


def main() -> int:
    cfg = json.loads(sys.stdin.readline())
    if cfg.get("cores"):
        os.sched_setaffinity(0, cfg["cores"])
    bodies = [b.encode() for b in cfg["bodies"]]
    sequence = cfg["sequence"]
    warm = []
    closed_loop(cfg, bodies, list(range(len(bodies))), 0, cfg["warmup"],
                time.monotonic(), float("inf"),
                lambda *r: warm.append(r))
    bad = [r for r in warm if r[4] != 200]
    print("WARM" if not bad else f"WARMFAIL {bad[0][4]}", flush=True)
    line = sys.stdin.readline().split()
    if not line or line[0] != "GO":
        return 1
    t0 = float(line[1])
    out, lock = [], threading.Lock()

    def record(*r):
        with lock:
            out.append(r)

    if cfg["loop"] == "closed":
        closed_loop(cfg, bodies, sequence, 0, float("inf"), t0,
                    t0 + cfg["seconds"], record)
    else:
        open_loop(cfg, bodies, sequence, t0, record)
    print(json.dumps({"requests": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

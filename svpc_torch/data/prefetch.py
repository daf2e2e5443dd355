"""Background host pipeline: build batches and copy them to the device
ahead of the training step (the port of svpc_tpu/data/prefetch.py).

A producer thread runs the numpy batch construction ``size`` batches
ahead.  On the card it stages each array in pinned host memory and copies
it with ``non_blocking=True`` on a side CUDA stream, recording an event;
the consumer's stream waits on that event before the batch is used, so
copies overlap the step in flight.  Errors raised by the producer surface
on the consumer side; a consumer that stops early stops the producer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import torch

from svpc_torch.model.svpc import FEATURE_KEYS, to_tensors

_SENTINEL = object()


def prefetch_to_device(iterator: Iterator, device, size: int = 2,
                       feature_dtype: torch.dtype = torch.float32
                       ) -> Iterator:
    """Wrap a (numpy batch, metas) iterator: yields (tensor batch on
    ``device``, metas), built and copied in a background thread; the
    video features are cast to ``feature_dtype`` on the device, after the
    copy (as ``to_tensors`` does; svpc_tpu/train/loop.py:250 casts them
    on the host)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    err = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def to_device(batch) -> tuple:
        if not cuda:
            return to_tensors(batch, device, feature_dtype), None
        host = to_tensors(batch, torch.device("cpu"))
        with torch.cuda.stream(copy_stream):
            out = {k: t.pin_memory().to(device, non_blocking=True)
                   for k, t in host.items()}
            out.update({k: out[k].to(feature_dtype)
                        for k in FEATURE_KEYS if k in out})
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    def producer():
        try:
            for batch, meta in iterator:
                if not put((to_device(batch), meta)):
                    return
        except BaseException as e:  # re-raised on the consumer side
            err.append(e)
        finally:
            put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            (batch, ready), meta = item
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                for v in batch.values():  # allocated on the copy stream
                    v.record_stream(stream)
            yield batch, meta
    finally:
        stop.set()  # unblocks the producer if the consumer exits early
        t.join(timeout=60)


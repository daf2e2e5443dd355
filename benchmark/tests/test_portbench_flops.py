"""The yardstick's arithmetic against counts made by hand."""

import threading
import time

import pytest

from pbench import flops, peaks, trace
from pbench.trace import Spans, summarize

C = dict(hidden_size=2, intermediate_size=4, lstm_hidden_size=2,
         num_hidden_layers=1, word_vec_size=3, video_feature_size=5,
         vocab_size=7, action_vocab_size=2, max_t_len=3, max_oov=1,
         model_mode="video")


def test_encoder_layer_by_hand():
    # n=3, H=2, I=4: Q, K, V and the output projection 4 * 2*3*2*2 = 96,
    # the FFN 2 * 2*3*2*4 = 96, QK^T and PV 2 * 2*3*3*2 = 72
    assert flops._encoder_layer(C, 3) == 96 + 96 + 72


def test_video_mode_encode_by_hand():
    # one clip of 1 frame (3 positions): video projection 2*3*5*2 = 60,
    # one encoder layer 264; the step encoder over 1 step:
    # 4 * 2*1*2*2 + 2 * 2*1*2*4 + 2 * 2*1*1*2 = 32 + 32 + 8 = 72
    assert flops.encode_flops(C, [1], 0, 0) == 60 + 264 + 72


def test_decode_position_by_hand():
    # word projection 2*3*2 = 12; one layer: 5 products of 2*2*2 = 40,
    # self-attention over 2 keys 4*2*2 = 16, cross over 1 memory row
    # 4*1*2 = 8; head 2*2*(2 + 7) = 36
    assert flops.decode_position_flops(C, 2, 0) == 12 + 40 + 16 + 8 + 36


def test_serve_and_train_totals_compose():
    per_clip = flops.clip_decode_setup_flops(C, 0) + sum(
        flops.decode_position_flops(C, t + 1, 0) for t in range(2))
    assert flops.serve_video_flops(C, [1, 2], 0, 0) == \
        flops.encode_flops(C, [1, 2], 0, 0) + 2 * per_clip
    fwd = flops.encode_flops(C, [1], 0, 0) + flops.clip_decode_setup_flops(
        C, 0) + sum(flops.decode_position_flops(C, t + 1, 0)
                    for t in range(3))
    assert flops.train_video_flops(C, [1], 0, 0) == 3 * fwd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bound_by_hand(dtype):
    n, lq, lk, h, item = 96, 1, 22, 768, 4 if dtype == "float32" else 2
    mask = n * lk
    ops = 4 * n * lq * lk * h
    nbytes = (2 * n * lq * h + 2 * n * lk * h) * item + mask * 4
    want = max(ops / peaks.ATTENTION_FLOPS_PER_S[dtype],
               nbytes / peaks.HBM_BYTES_PER_S)
    got = flops.attention_bound_s(n, lq, lk, h, mask, item, 4, dtype)
    assert got == pytest.approx(want, rel=1e-12)
    # a decode step of this size is bound by its bytes
    assert got == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S, rel=1e-12)


def test_trace_summary_busy_union_and_gaps():
    spans = Spans()
    spans.on = True
    spans.add("build", 10.0, 10.000004)   # covers the first gap's middle
    dev = [(1.0, 3.0, "a"), (2.0, 4.0, "b"), (6.0, 7.0, "a")]
    out = summarize(dev, 10.0, spans, t_start=10.0)
    assert out["busy_s"] == pytest.approx(4e-6)   # [1, 4] and [6, 7]
    assert out["window_s"] == pytest.approx(1e-5)
    assert [n for n, _ in out["device_ops"]] == ["a", "b"]
    gaps = {round(s * 1e6, 6): n for n, s in out["idle_gaps"]}
    assert gaps == {3.0: "none", 2.0: "none", 1.0: "build"}


def _held_elsewhere(lock) -> bool:
    """Whether another thread holds ``lock``."""
    out = []

    def probe():
        got = lock.acquire(blocking=False)
        if got:
            lock.release()
        out.append(not got)

    t = threading.Thread(target=probe)
    t.start()
    t.join()
    return out[0]


def test_profiled_slice_starts_and_stops_holding_quiet(monkeypatch,
                                                       tmp_path):
    # torch.profiler starting or stopping across a CUDA graph replay in
    # another thread can deadlock: the spans hold Spans.quiet, and so does
    # the slice while it starts and stops the profiler
    quiet = Spans().quiet
    seen = []

    class Slice:
        def __init__(self, workdir):
            pass

        def start(self):
            seen.append(("start", _held_elsewhere(quiet)))

        def stop(self):
            seen.append(("stop", _held_elsewhere(quiet)))

    monkeypatch.setattr(trace, "ProfilerSlice", Slice)
    trace.profile_window(lambda on: seen.append((on, _held_elsewhere(quiet))),
                         0.0, 0.01, time.monotonic(), str(tmp_path), quiet)
    assert seen == [("start", True), (True, False), (False, False),
                    ("stop", True)]
    assert not _held_elsewhere(quiet)


def test_spans_hold_quiet_around_the_calls_they_time():
    s = Spans()
    inner = s.wrap("copy", lambda: _held_elsewhere(s.quiet))
    outer = s.wrap("decode", lambda: (_held_elsewhere(s.quiet), inner()))
    assert outer() == (False, False)  # off: neither held nor timed
    assert s.items == []
    s.on = True
    assert outer() == (True, True)  # spans may nest
    assert [n for n, _, _ in s.items] == ["copy", "decode"]
    assert not _held_elsewhere(s.quiet)

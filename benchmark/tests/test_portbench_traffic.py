"""The seeded pool and schedule: the same for one seed, another order of
the same sizes and arrivals for another seed."""

import json
import os

import numpy as np

from pbench.fixture import _plan, write_pool
from pbench.serve import _schedule

TRAFFIC = dict(pool_videos=12, segments=[3, 16], segments_mean=7.7,
               segment_s_mean=19.6, segment_shape=2.0, video_s_mean=315.6,
               ingredients=[2, 6], plan_seed=0, feature_files=5,
               loop="open", rate_per_s=35.0)
C = dict(vocab_size=40, action_vocab_size=5, video_feature_size=6,
         max_oov=16, max_t_len=8)


def _sizes(fx):
    return sorted((len(s["timestamps"]), len(s["ingredients"]))
                  for s in fx["specs"].values())


def test_pool_repeats_for_a_seed_and_permutes_across_seeds(tmp_path):
    a = write_pool(str(tmp_path / "a"), C, TRAFFIC, 2 ** 31 + 5)
    b = write_pool(str(tmp_path / "b"), C, TRAFFIC, 2 ** 31 + 5)
    c = write_pool(str(tmp_path / "c"), C, TRAFFIC, 2 ** 31 + 6)
    assert a["specs"] == b["specs"]
    fa = np.load(os.path.join(a["video_feature_dir"], "vid0000_bn.npy"))
    fb = np.load(os.path.join(b["video_feature_dir"], "vid0000_bn.npy"))
    fc = np.load(os.path.join(c["video_feature_dir"], "vid0000_bn.npy"))
    assert np.array_equal(fa, fb) and not np.array_equal(fa[:1], fc[:1])
    assert a["specs"] != c["specs"]
    assert _sizes(a) == _sizes(c)      # the same work, another order



def test_pool_follows_the_published_statistics():
    plan = _plan(2000, TRAFFIC, 16)
    counts = [p["n_clips"] for p in plan]
    spans = [e - s for p in plan for s, e in p["timestamps"]]
    assert 3 <= min(counts) and max(counts) <= 16
    assert abs(np.mean(counts) - 7.7) < 0.1
    assert abs(np.mean(spans) - 19.6) < 0.5 and min(spans) >= 0.99
    assert abs(np.mean([p["duration"] for p in plan]) - 315.6) < 6.0
    for p in plan:  # in order, inside the video
        ends = [0.0] + [x for ts in p["timestamps"] for x in ts]
        assert ends == sorted(ends) and ends[-1] <= p["duration"]


def test_videos_link_to_the_shared_feature_files(tmp_path):
    fx = write_pool(str(tmp_path), C, TRAFFIC, 9)
    inodes = {os.stat(os.path.join(fx["video_feature_dir"],
                                   f"{n}_resnet.npy")).st_ino
              for n in fx["specs"]}
    assert len(fx["specs"]) == 12 and len(inodes) == 5


def test_annotated_pool_writes_the_train_split(tmp_path):
    fx = write_pool(str(tmp_path), C, TRAFFIC, 3, annotated=True)
    with open(os.path.join(fx["data_dir"],
                           "bosselut_yc2_train_anet_format.json")) as f:
        split = json.load(f)
    assert sorted(split) == sorted(fx["specs"])
    for e in split.values():
        assert len(e["sentences"]) == len(e["timestamps"]) == \
            len(e["alignment"]) == len(e["action"])


def test_schedule_repeats_for_a_seed_and_permutes_across_seeds():
    seq_a, off_a = _schedule(TRAFFIC, 2 ** 32 - 3, 12, 20.0)
    seq_b, off_b = _schedule(TRAFFIC, 2 ** 32 - 3, 12, 20.0)
    seq_c, off_c = _schedule(TRAFFIC, 11, 12, 20.0)
    assert (seq_a, off_a) == (seq_b, off_b)
    assert seq_a != seq_c and off_a != off_c
    # the same gaps in another order; every pool video once a cycle
    gaps = lambda off: sorted(np.diff([0.0] + off).round(9))
    assert gaps(off_a) == gaps(off_c)
    assert sorted(seq_a[:12]) == list(range(12))
    rate = sum(o < 20.0 for o in off_a) / 20.0
    assert abs(rate - 35.0) < 5.0

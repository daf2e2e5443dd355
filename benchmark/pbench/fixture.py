"""The benchmark's data: a pool of synthetic recipe videos on disk, as a
deployment stages them (per-video ``<vid>_resnet.npy`` + ``<vid>_bn.npy``
feature files, a duration CSV, the word and verb vocabularies), and for
training the annotated split file the trainer reads.

Frozen from svpc_torch/data/synthetic.py (``write_serving_fixture``,
``write_training_fixture``) at commit aeb5374, with three changes:

- the sizes of the pool (segments a video, their lengths and the gaps
  between them, ingredient counts and word kinds) are drawn from the
  published statistics the traffic file states, fixed by its
  ``plan_seed`` and the same for every run; the run's ``--seed`` permutes
  them over the video names and draws every value (features, words,
  sentences, labels), so every seed gives the same work in another order;
- a video's feature rows sit at 0.5 s a row over its whole length, as
  YouCook2's features do;
- the feature files are ``feature_files`` pairs of the pool's longest
  length, and each video's pair is a hard link to one of them.  A loader
  reads only the rows of a video's own segments (the native packer maps
  each path on its own), so this changes no read, and it keeps what a run
  writes to a few hundred MB however many videos the pool has.

The training split file lists the videos in the plan's order (the video
with the plan's first sizes first), so that a shuffle fixed by
``plan_seed`` cuts every seed's pool into batches of the same sizes.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np

from pbench.reference.inputs import clip_rows, frm2sec, ingredient_arrays

SPECIAL = ["[PAD]", "[CLS]", "[SEP]", "[VID]", "[BOS]", "[EOS]", "[UNK]"]
TRAIN_SPLIT_FILE = "bosselut_yc2_train_anet_format.json"
FPS = 30  # the duration CSV's frames a second


def _plan(n_videos: int, t: Dict, max_oov: int):
    """Each video's sizes, fixed by ``t["plan_seed"]``: ``segments`` =
    [lo, hi] a video, lo + Binomial(hi - lo, p) with the mean
    ``segments_mean``; each segment Gamma(``segment_shape``) seconds with
    the mean ``segment_s_mean`` (at least 1 s); the n + 1 gaps before,
    between and after them exponential, with the mean that makes
    ``video_s_mean`` the mean length of a video; then the ingredients'
    word kinds (``ingredients`` = [lo, hi] a video, a quarter out of the
    vocabulary)."""
    rng = np.random.RandomState(t["plan_seed"])
    lo, hi = t["segments"]
    n_mean, seg_mean = t["segments_mean"], t["segment_s_mean"]
    gap_mean = (t["video_s_mean"] - n_mean * seg_mean) / (n_mean + 1)
    shape = t["segment_shape"]
    plan = []
    for _ in range(n_videos):
        n = lo + int(rng.binomial(hi - lo, (n_mean - lo) / (hi - lo)))
        spans = np.maximum(rng.gamma(shape, seg_mean / shape, size=n), 1.0)
        gaps = rng.exponential(gap_mean, size=n + 1)
        at, stamps = 0.0, []
        for span, gap in zip(spans, gaps):
            at += gap
            stamps.append([round(at, 2), round(at + span, 2)])
            at += span
        ingr = []
        n_oov = 0
        for _ in range(int(rng.randint(t["ingredients"][0],
                                       t["ingredients"][1] + 1))):
            kinds = ["oov" if rng.rand() < 0.25 and n_oov < max_oov
                     else "word"]
            n_oov += kinds[0] == "oov"
            if rng.rand() < 0.5:
                kinds.append("word")
            ingr.append(kinds)
        plan.append(dict(n_clips=n, duration=at + gaps[-1],
                         ingredients=ingr, timestamps=stamps))
    return plan


def write_pool(root: str, c: Dict, traffic: Dict, seed: int,
               annotated: bool = False) -> Dict:
    """Write ``traffic["pool_videos"]`` videos under ``root``.  Returns
    the paths, ``specs`` (video id -> request body, in id order) and
    ``frm2sec`` (video id -> seconds a feature frame); with
    ``annotated`` also the train split file (sentences, alignment rows,
    verb dicts) under ``root``."""
    V, A, D = c["vocab_size"], c["action_vocab_size"], c["video_feature_size"]
    plan = _plan(traffic["pool_videos"], traffic, c["max_oov"])
    rng = np.random.RandomState(
        np.random.SeedSequence([seed, 1]).generate_state(1)[0])
    feats = np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed, 2])))
    order = rng.permutation(len(plan))
    feat_dir = os.path.join(root, "features")
    os.makedirs(feat_dir, exist_ok=True)
    word2idx = {t: i for i, t in enumerate(SPECIAL)}
    for i in range(len(SPECIAL), V):
        word2idx[f"word{i}"] = i
    paths = dict(word2idx_path=os.path.join(root, "word2idx.json"),
                 verb2idx_path=os.path.join(root, "verb2idx.json"),
                 duration_file=os.path.join(root, "durations.csv"),
                 video_feature_dir=feat_dir, data_dir=root)
    with open(paths["word2idx_path"], "w") as f:
        json.dump(word2idx, f)
    with open(paths["verb2idx_path"], "w") as f:
        json.dump({f"verb{i}": i for i in range(A)}, f)
    word = lambda: f"word{len(SPECIAL) + rng.randint(V - len(SPECIAL))}"
    specs, rows, split, f2s_of = {}, [], {}, {}
    plan = [plan[j] for j in order]
    n_frames = [int(p["duration"] * FPS) for p in plan]
    f2s = [frm2sec(p["duration"], n) for p, n in zip(plan, n_frames)]
    n_rows = max(max(int(math.ceil(p["duration"] / f)) + 2, 8)
                 for p, f in zip(plan, f2s))
    n_resnet = (2 * D) // 3
    bank_dir = os.path.join(root, "feature_files")
    os.makedirs(bank_dir, exist_ok=True)
    bank = [{key: os.path.join(bank_dir, f"{k}_{key}.npy")
             for key in ("resnet", "bn")}
            for k in range(min(traffic["feature_files"], len(plan)))]
    for files in bank:
        for key, width in (("resnet", n_resnet), ("bn", D - n_resnet)):
            np.save(files[key],
                    feats.standard_normal((n_rows, width), np.float32))
    for v, p in enumerate(plan):
        name = f"vid{v:04d}"
        for key, path in bank[v % len(bank)].items():
            os.link(path, os.path.join(feat_dir, f"{name}_{key}.npy"))
        rows.append(f"{name},{p['duration']},{n_frames[v]}\n")
        f2s_of[name] = f2s[v]
        ingredients = [" ".join(word() if k == "word" else f"spice{v}x{e}"
                                for k in kinds)
                       for e, kinds in enumerate(p["ingredients"])]
        specs[name] = {"timestamps": p["timestamps"],
                       "ingredients": ingredients}
        if annotated:
            ingr_words = " ".join(ingredients).split()
            sentences, alignment, action = [], [], []
            for _ in p["timestamps"]:
                words = []
                for _ in range(rng.randint(3, max(4, c["max_t_len"] - 3))):
                    r = rng.rand()
                    words.append(ingr_words[rng.randint(len(ingr_words))]
                                 if r < 0.2 else "zzunknown" if r < 0.25
                                 else word())
                sentences.append(" ".join(words))
                alignment.append([int(rng.rand() < 0.3)
                                  for _ in ingredients])
                verbs = rng.choice(A, size=rng.randint(1, 3), replace=False)
                action.append({f"verb{x}": int(x) for x in verbs})
            split[name] = dict(specs[name], sentences=sentences,
                               alignment=alignment, action=action)
    with open(paths["duration_file"], "w") as f:
        f.writelines(rows)
    if annotated:  # in the plan's order: see train.py's shuffle
        by_plan = [f"vid{v:04d}" for v in np.argsort(order)]
        with open(os.path.join(root, TRAIN_SPLIT_FILE), "w") as f:
            json.dump({name: split[name] for name in by_plan}, f)
    return dict(paths, specs=specs, frm2sec=f2s_of)


def pool_sizes(c: Dict, fx: Dict) -> Dict:
    """Video id -> (each clip's real feature rows, entities, ingredient
    tokens), worked out from the written files, for the operation
    counts."""
    with open(fx["word2idx_path"]) as f:
        word2idx = json.load(f)
    out = {}
    for name, spec in fx["specs"].items():
        n_rows = np.load(os.path.join(fx["video_feature_dir"],
                                      f"{name}_resnet.npy"),
                         mmap_mode="r").shape[0]
        frames = [len(clip_rows(n_rows, t, fx["frm2sec"][name],
                                c["max_v_len"]))
                  for t in spec["timestamps"][:c["max_n_sen"]]]
        ingr, _ = ingredient_arrays(spec["ingredients"], word2idx, c)
        out[name] = (frames, int(ingr["entity_mask"].sum()),
                     int((ingr["ingr_ids"] != 0).sum()))
    return out

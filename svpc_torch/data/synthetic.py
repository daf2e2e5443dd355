"""Synthetic data made from a seed: fixed-shape numpy batches (tests,
kernel checks), an on-disk serving fixture (vocab, verb vocab, duration
CSV and per-video feature files) that the serving path reads exactly like
real YC2 data, and a training fixture that adds annotated train / val /
test split files and the val / test paragraph references the language
scorers read.  Nothing here reads outside data."""

from __future__ import annotations

import json
import math
import os

import numpy as np

from svpc_torch import tokenization as tok
from svpc_torch.config import Config


def synthetic_batch(cfg: Config, batch_size: int = 2, seed: int = 0,
                    num_steps: int | None = None,
                    full_steps: bool = False) -> dict:
    """Random but structurally valid fixed-shape batch.

    ``full_steps=True`` gives every example the maximum step count —
    deterministic work content for benchmarking.
    """
    m = cfg.model
    rng = np.random.RandomState(seed)
    S = num_steps or m.max_n_sen
    L = m.max_v_len + m.max_t_len
    Lv, Lt = m.max_v_len, m.max_t_len
    B = batch_size
    V = m.vocab_size

    batch = dict(
        input_ids=np.zeros((B, S, L), np.int32),
        input_labels=np.full((B, S, L), tok.IGNORE, np.int32),
        input_mask=np.zeros((B, S, L), np.float32),
        token_type_ids=np.zeros((B, S, L), np.int32),
        video_feature=np.zeros((B, S, Lv, m.video_feature_size), np.float32),
        step_mask=np.zeros((B, S), np.float32),
        ingr_ids=np.zeros((B, m.max_i_len), np.int32),
        ingr_mask=np.zeros((B, m.max_i_len), np.int32),
        ingr_sep_mask=np.zeros((B, m.max_i_len), np.int32),
        entity_mask=np.zeros((B, m.max_entities), np.float32),
        copy_ids=np.zeros((B, m.max_entities, m.max_ingr_words), np.int32),
        copy_weights=np.zeros((B, m.max_entities, m.max_ingr_words), np.float32),
        oov_count=np.zeros((B,), np.int32),
        alignment=np.zeros((B, S, m.max_entities), np.float32),
        action=np.zeros((B, S, m.action_vocab_size), np.float32),
        action_row_mask=np.zeros((B, S), np.float32),
    )

    for b in range(B):
        n_steps = S if full_steps else rng.randint(1, S + 1)
        batch["step_mask"][b, :n_steps] = 1.0
        for s in range(n_steps):
            v_valid = Lv - 2 if full_steps else rng.randint(1, Lv - 1)
            ids_v = [tok.CLS] + [tok.VID] * v_valid + [tok.SEP] \
                + [tok.PAD] * (Lv - 2 - v_valid)
            n_words = Lt - 2 if full_steps else rng.randint(1, Lt - 1)
            words = rng.randint(7, V, size=n_words).tolist()
            ids_t = ([tok.BOS] + words + [tok.EOS]
                     + [tok.PAD] * (Lt - 2 - n_words))
            batch["input_ids"][b, s] = ids_v + ids_t
            batch["input_mask"][b, s, :v_valid + 2] = 1
            batch["input_mask"][b, s, Lv:Lv + n_words + 2] = 1
            labels = [tok.IGNORE] * Lv + words + [tok.EOS] \
                + [tok.IGNORE] * (Lt - 1 - n_words)
            batch["input_labels"][b, s] = labels
            batch["token_type_ids"][b, s, Lv:] = 1
            batch["video_feature"][b, s, 1:v_valid + 1] = rng.randn(
                v_valid, m.video_feature_size).astype(np.float32)

        n_ent = (m.max_entities if full_steps
                 else rng.randint(1, m.max_entities + 1))
        pos = 0
        oov = 0
        for e in range(n_ent):
            n_w = rng.randint(1, min(2, m.max_ingr_words) + 1)
            if pos + n_w + 1 > m.max_i_len:
                break
            group = []
            for w in range(n_w):
                if oov < m.max_oov and rng.rand() < 0.2:
                    wid = V + oov
                    batch["ingr_ids"][b, pos] = tok.UNK
                    oov += 1
                else:
                    wid = int(rng.randint(7, V))
                    batch["ingr_ids"][b, pos] = wid
                group.append(wid)
                pos += 1
            batch["ingr_ids"][b, pos] = tok.SEP
            batch["ingr_sep_mask"][b, pos] = 1
            pos += 1
            batch["entity_mask"][b, e] = 1.0
            for k, wid in enumerate(group):
                batch["copy_ids"][b, e, k] = wid
                batch["copy_weights"][b, e, k] = 1.0 / len(group)
        batch["ingr_mask"][b, :pos] = 1
        batch["oov_count"][b] = oov

        n_ent_actual = int(batch["entity_mask"][b].sum())
        batch["alignment"][b, :n_steps, :n_ent_actual] = (
            rng.rand(n_steps, n_ent_actual) < 0.3).astype(np.float32)
        acts = (rng.rand(n_steps, m.action_vocab_size) < 0.05).astype(np.float32)
        batch["action"][b, :n_steps] = acts
        batch["action_row_mask"][b] = (
            batch["action"][b].sum(-1) > 0).astype(np.float32) \
            * batch["step_mask"][b]
    return batch


def _write_video_features(feature_dir: str, name: str, duration: float,
                          feature_size: int, rng) -> str:
    """Random ``<name>_resnet.npy`` + ``<name>_bn.npy`` whose row count is
    consistent with a 30 fps video of ``duration`` seconds under the yc2
    frm2sec math (data/anet.duration_to_frm2sec); returns the CSV row."""
    n_frames = int(duration * 30)
    frm2sec = duration * math.ceil(n_frames / duration * 0.5) / n_frames
    feat_len = max(int(math.ceil(duration / frm2sec)) + 2, 8)
    n_resnet = (2 * feature_size) // 3  # 2048 + 1024 at the real width
    np.save(os.path.join(feature_dir, f"{name}_resnet.npy"),
            rng.randn(feat_len, n_resnet).astype(np.float32))
    np.save(os.path.join(feature_dir, f"{name}_bn.npy"),
            rng.randn(feat_len, feature_size - n_resnet).astype(np.float32))
    return f"{name},{duration},{n_frames}\n"


def write_serving_fixture(root: str, cfg: Config, n_videos: int = 12,
                          min_clips: int = 3, max_clips: int = 12,
                          seed: int = 0) -> dict:
    """Write a serving fixture under ``root`` at ``cfg``'s geometry.

    Files: ``word2idx.json`` (``cfg.model.vocab_size`` words; the special
    tokens at the ids of tokenization.py), ``verb2idx.json``
    (``action_vocab_size`` verbs), ``durations.csv`` and
    ``features/<vid>_{resnet,bn}.npy``.  Each video gets ``min_clips`` to
    ``max_clips`` clips and a few ingredients mixing in-vocabulary and
    out-of-vocabulary words (so the copy path has OOV ids to produce).

    Returns ``dict(word2idx_path, verb2idx_path, duration_file,
    video_feature_dir, specs)`` where ``specs`` maps video id to the
    request body ``{"timestamps": [[s, e], ...], "ingredients": [...]}``.
    """
    m = cfg.model
    rng = np.random.RandomState(seed)
    feat_dir = os.path.join(root, "features")
    os.makedirs(feat_dir, exist_ok=True)

    word2idx = dict(tok.SPECIAL_TOKENS)
    for i in range(len(word2idx), m.vocab_size):
        word2idx[f"word{i}"] = i
    paths = dict(word2idx_path=os.path.join(root, "word2idx.json"),
                 verb2idx_path=os.path.join(root, "verb2idx.json"),
                 duration_file=os.path.join(root, "durations.csv"),
                 video_feature_dir=feat_dir)
    with open(paths["word2idx_path"], "w") as f:
        json.dump(word2idx, f)
    with open(paths["verb2idx_path"], "w") as f:
        json.dump({f"verb{i}": i for i in range(m.action_vocab_size)}, f)

    n_words = m.vocab_size - len(tok.SPECIAL_TOKENS)
    specs, rows = {}, []
    for v in range(n_videos):
        name = f"vid{v:03d}"
        n_clips = int(rng.randint(min_clips, max_clips + 1))
        duration = float(rng.uniform(8.0, 20.0) * n_clips)
        rows.append(_write_video_features(feat_dir, name, duration,
                                          m.video_feature_size, rng))
        bounds = np.sort(rng.uniform(0.0, duration, size=2 * n_clips))
        timestamps = [[round(float(bounds[2 * c]), 2),
                       round(float(bounds[2 * c + 1]), 2)]
                      for c in range(n_clips)]
        ingredients = []
        for e in range(int(rng.randint(2, min(6, m.max_entities) + 1))):
            words = [f"word{len(tok.SPECIAL_TOKENS) + rng.randint(n_words)}"
                     if rng.rand() > 0.25 else f"spice{v}x{e}"]
            if rng.rand() < 0.5 and m.max_ingr_words > 1:
                words.append(f"word{len(tok.SPECIAL_TOKENS) + rng.randint(n_words)}")
            ingredients.append(" ".join(words))
        specs[name] = {"timestamps": timestamps, "ingredients": ingredients}
    with open(paths["duration_file"], "w") as f:
        f.writelines(rows)
    return dict(paths, specs=specs)


def write_training_fixture(root: str, cfg: Config, n_train: int,
                           n_val: int, seed: int = 0, min_clips: int = 3,
                           max_clips: int = 12) -> dict:
    """Write a training fixture under ``root``: the serving fixture's
    files for ``n_train + 2 * n_val`` videos, plus annotated split files
    under the names data/anet.py loads
    (``bosselut_yc2_train_anet_format.json``,
    ``bosselut_split_yc2_{val,test}_anet_format.json``; the test split has
    ``n_val`` videos, after the train and val ones, so that those do not
    depend on it) and the paragraph references of the val and test splits
    (``yc2_split_{val,test}_anet_format_para.json``, ``{vid: paragraph}``
    with each clip's sentence ending in a period), so ``root`` is the
    ``data_dir``.  Each clip gets a sentence of fixture-vocabulary words,
    the video's own ingredient words (out-of-vocabulary ones included, so
    the copy path has targets) and the odd unknown word; each step gets an
    ``alignment`` row over the ingredients and an ``action`` dict of one
    or two verbs.  A video keeps at most ``cfg.model.max_oov`` distinct
    out-of-vocabulary ingredient words (the annotated splits' budget).

    Returns the serving fixture's dict plus ``data_dir``."""
    from svpc_torch.data.anet import PARA_REFERENCE_FILES, SPLIT_FILES

    m = cfg.model
    fx = write_serving_fixture(root, cfg, n_videos=n_train + 2 * n_val,
                               min_clips=min_clips, max_clips=max_clips,
                               seed=seed)
    rng = np.random.RandomState(seed + 1)
    n_special = len(tok.SPECIAL_TOKENS)
    vocab_word = lambda: f"word{n_special + rng.randint(m.vocab_size - n_special)}"
    splits = {"train": {}, "val": {}, "test": {}}
    for i, (name, spec) in enumerate(fx["specs"].items()):
        oov, ingredients = set(), []
        for ingr in spec["ingredients"]:
            words = []
            for w in ingr.split():
                if not w.startswith("word") and w not in oov:
                    if len(oov) >= m.max_oov:
                        w = vocab_word()
                    else:
                        oov.add(w)
                words.append(w)
            ingredients.append(" ".join(words))
        ingr_words = " ".join(ingredients).split()
        sentences, alignment, action = [], [], []
        for _ in spec["timestamps"]:
            words = []
            for _ in range(rng.randint(3, max(4, m.max_t_len - 3))):
                r = rng.rand()
                words.append(ingr_words[rng.randint(len(ingr_words))]
                             if r < 0.2 else "zzunknown" if r < 0.25
                             else vocab_word())
            sentences.append(" ".join(words))
            alignment.append([int(rng.rand() < 0.3)
                              for _ in ingredients])
            verbs = rng.choice(m.action_vocab_size,
                               size=rng.randint(1, 3), replace=False)
            action.append({f"verb{v}": int(v) for v in verbs})
        split = ("train" if i < n_train else
                 "val" if i < n_train + n_val else "test")
        splits[split][name] = dict(
            spec, ingredients=ingredients, sentences=sentences,
            alignment=alignment, action=action)
    for split, entries in splits.items():
        with open(os.path.join(root, SPLIT_FILES[split]), "w") as f:
            json.dump(entries, f)
    for split, fn in PARA_REFERENCE_FILES.items():
        with open(os.path.join(root, fn), "w") as f:
            json.dump({name: " ".join(f"{s}." for s in e["sentences"])
                       for name, e in splits[split].items()}, f)
    return dict(fx, data_dir=root)

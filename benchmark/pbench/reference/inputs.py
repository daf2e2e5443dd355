"""Plain inputs for the reference, worked out from the raw files the
benchmark wrote (the feature .npy pairs, the duration CSV, the
vocabularies, the annotated split) and the request itself: one served
request -> the dense arrays of one video; the videos of one training
step -> the packed batch the step trains on.

Frozen from the semantics of svpc_torch/data/{anet,features,pipeline}.py
and svpc_torch/tokenization.py at commit aeb5374 (YouCook2's feature
sampling: 0.5 s a feature frame, spans longer than max_v_len - 2 rows
downsampled by linspace; ingredient words tokenized, out-of-vocabulary
words given ids after the vocabulary in first-seen order, each
ingredient a copy group; a sentence ``[BOS] w* [EOS]`` with its labels
shifted left; the packed layout of svpc_torch/data/packing.py: the real
clips of the batch in video order, their count and the longest video
span rounded up to the traffic's multiples).  The benchmark's fixtures
hold only lower-case alphanumeric words, which the tokenizer leaves
whole; anything else is refused here.  It imports nothing of the
program.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np

from pbench.reference.model import BOS, CLS, EOS, PAD, SEP, UNK, VID

SEP_TOKEN = "[SEP]"
IGNORE = -1  # a label the caption loss leaves out


def frm2sec(duration: float, n_frames: float) -> float:
    """Seconds a feature frame (YouCook2: 0.5 s sampling)."""
    return duration * math.ceil(n_frames / duration * 0.5) / n_frames


def clip_rows(n_rows: int, ts, f2s: float, max_v_len: int):
    """Feature row indices of one clip (at most max_v_len - 2)."""
    st = int(math.floor(ts[0] / f2s))
    ed = min(int(math.ceil(ts[1] / f2s)), n_rows - 1)
    st = max(min(st, ed - 1), 0)
    if ed - st + 1 > max_v_len - 2:
        return np.linspace(st, ed, max_v_len - 2,
                           endpoint=True).astype(np.int64)
    return np.arange(st, ed + 1)


def _words(text: str) -> List[str]:
    words = text.lower().split()
    for w in words:
        if not w.isalnum():
            raise ValueError(f"fixture word {w!r} is not alphanumeric")
    return words


def ingredient_arrays(ingredients, word2idx: Dict[str, int], c: Dict):
    V = c["vocab_size"]
    toks: List[str] = []
    for ingr in ingredients:
        toks.extend(_words(ingr))
        toks.append(SEP_TOKEN)
    toks = toks[:c["max_i_len"]]
    ids = np.zeros(c["max_i_len"], np.int64)
    sep = np.zeros(c["max_i_len"], np.int64)
    oov: Dict[str, int] = {}
    groups, cur = [], []
    for i, t in enumerate(toks):
        if t == SEP_TOKEN:
            ids[i], sep[i] = SEP, 1
            groups.append(cur)
            cur = []
            continue
        wid = word2idx.get(t, UNK)
        ids[i] = wid
        if wid == UNK:
            oov.setdefault(t, V + len(oov))
            wid = oov[t]
        cur.append(wid)
    E, K = c["max_entities"], c["max_ingr_words"]
    if len(oov) > c["max_oov"] or len(groups) > E or \
            any(len(g) > K for g in groups):
        raise ValueError("ingredients exceed the configuration's budgets")
    copy_ids = np.zeros((E, K), np.int64)
    copy_w = np.zeros((E, K), np.float32)
    for e, g in enumerate(groups):
        copy_ids[e, :len(g)] = g
        copy_w[e, :len(g)] = 1.0 / len(g)
    emask = np.zeros(E, np.float32)
    emask[:len(groups)] = 1.0
    return dict(ingr_ids=ids, ingr_sep_mask=sep, entity_mask=emask,
                copy_ids=copy_ids, copy_weights=copy_w,
                oov_count=np.asarray(len(oov), np.int64)), oov


def video_arrays(feature_dir: str, name: str, timestamps, f2s: float,
                 c: Dict):
    """(S, L) token ids and mask of the video span, (S, Lv, D) features."""
    raw = np.concatenate([np.load(os.path.join(feature_dir,
                                               f"{name}_{k}.npy"))
                          for k in ("resnet", "bn")], axis=1)
    Lv, L = c["max_v_len"], c["max_v_len"] + c["max_t_len"]
    S = len(timestamps)
    ids = np.zeros((S, L), np.int64)
    mask = np.zeros((S, L), np.float32)
    feat = np.zeros((S, Lv, raw.shape[1]), np.float32)
    for s, ts in enumerate(timestamps):
        rows = clip_rows(len(raw), ts, f2s, Lv)
        n = len(rows)
        ids[s, :n + 2] = [CLS] + [VID] * n + [SEP]
        ids[s, n + 2:Lv] = PAD
        mask[s, :n + 2] = 1.0
        feat[s, 1:n + 1] = raw[rows]
    return ids, mask, feat


def _round_up(n: int, multiple: int, cap: int = None) -> int:
    r = max(multiple, -(-n // multiple) * multiple)
    return min(r, cap) if cap is not None else r


def _clip_tokens(sentence: str, n_rows: int, word2idx: Dict[str, int],
                 oov: Dict[str, int], c: Dict):
    """One clip of ``n_rows`` feature rows and its sentence -> (ids,
    labels, mask) of length max_v_len + max_t_len."""
    Lv, T = c["max_v_len"], c["max_t_len"]
    words = _words(sentence)[:T - 2]
    ids = np.full(Lv + T, PAD, np.int64)
    mask = np.zeros(Lv + T, np.float32)
    labels = np.full(Lv + T, IGNORE, np.int64)
    ids[:n_rows + 2] = [CLS] + [VID] * n_rows + [SEP]
    mask[:n_rows + 2] = 1.0
    text = [BOS] + [word2idx.get(w, UNK) for w in words] + [EOS]
    ext = [BOS] + [word2idx[w] if w in word2idx else oov.get(w, UNK)
                   for w in words] + [EOS]
    ids[Lv:Lv + len(text)] = text
    mask[Lv:Lv + len(text)] = 1.0
    labels[Lv:Lv + len(ext) - 1] = ext[1:]
    return ids, labels, mask


def train_batch(fixture: Dict, split: Dict, names, batch_size: int,
                word2idx: Dict[str, int], c: Dict, clip_multiple: int,
                v_multiple: int) -> Dict[str, np.ndarray]:
    """The packed batch of the videos ``names`` (in the batch's order, up
    to ``batch_size`` slots) of the annotated ``split``."""
    Lv, T, S = c["max_v_len"], c["max_t_len"], c["max_n_sen"]
    S = min(S, max(len(e["sentences"]) for e in split.values()))
    E, A = c["max_entities"], c["action_vocab_size"]
    per_video = {k: [] for k in ("ingr_ids", "ingr_sep_mask", "entity_mask",
                                 "copy_ids", "copy_weights", "oov_count")}
    clips = []  # (video slot, step, ids, labels, mask, feature rows)
    step_mask = np.zeros((batch_size, S), np.float32)
    alignment = np.zeros((batch_size, S, E), np.float32)
    action = np.zeros((batch_size, S, A), np.float32)
    for b, name in enumerate(names):
        e = split[name]
        n = min(len(e["sentences"]), S)
        ingr, oov = ingredient_arrays(e["ingredients"], word2idx, c)
        for k in per_video:
            per_video[k].append(ingr[k])
        raw = np.concatenate([np.load(os.path.join(
            fixture["video_feature_dir"], f"{name}_{k}.npy"), mmap_mode="r")
            for k in ("resnet", "bn")], axis=1)
        for s in range(n):
            rows = clip_rows(len(raw), e["timestamps"][s],
                             fixture["frm2sec"][name], Lv)
            ids, labels, mask = _clip_tokens(e["sentences"][s], len(rows),
                                             word2idx, oov, c)
            clips.append((b, s, ids, labels, mask, raw[rows]))
        step_mask[b, :n] = 1.0
        for s, row in enumerate(e["alignment"][:S]):
            alignment[b, s, :min(len(row), E)] = row[:E]
        for s, verbs in enumerate(e["action"][:S]):
            action[b, s, list(verbs.values())] = 1.0
    out = {k: np.stack(v + [np.zeros_like(v[0])] * (batch_size - len(v)))
           for k, v in per_video.items()}
    out.update(step_mask=step_mask, alignment=alignment, action=action,
               action_row_mask=(action.sum(-1) > 0) * step_mask)
    N = _round_up(len(clips), clip_multiple)
    v_len = _round_up(max([len(x[5]) + 2 for x in clips] + [2]),
                      v_multiple, cap=Lv)
    D = clips[0][5].shape[1]
    out.update(clip_video=np.zeros(N, np.int64),
               clip_step=np.zeros(N, np.int64),
               clip_mask=np.zeros(N, np.float32),
               clip_input_ids=np.zeros((N, v_len + T), np.int64),
               clip_input_labels=np.full((N, v_len + T), IGNORE, np.int64),
               clip_input_mask=np.zeros((N, v_len + T), np.float32),
               clip_video_feature=np.zeros((N, v_len, D), np.float32))
    for i, (b, s, ids, labels, mask, feat) in enumerate(clips):
        out["clip_video"][i], out["clip_step"][i] = b, s
        out["clip_mask"][i] = 1.0
        for key, arr in (("clip_input_ids", ids),
                         ("clip_input_labels", labels),
                         ("clip_input_mask", mask)):
            out[key][i] = np.concatenate([arr[:v_len], arr[Lv:]])
        out["clip_video_feature"][i, 1:len(feat) + 1] = feat
    return out

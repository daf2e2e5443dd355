"""Fixed-shape host data pipeline.

The reference's dataset emits ragged per-video lists of per-clip dicts that
a custom collate pads to the *batch* max step count and transposes into a
list of per-step batches (reference: recursive_caption_dataset.py:503-589).
The model then loops over examples in Python (model.py:1059).

Every video becomes one fixed-shape example ``(S, L, ...)`` with validity
masks; a batch is a plain stack.  Everything downstream (model, decode) is
mask-driven.  This is the port's copy of svpc_tpu/data/pipeline.py: the
numpy feature fill only (the native C++ packer is a later slice).

Shapes (per example):
  input_ids       (S, L)  int32     L = max_v_len + max_t_len
  input_mask      (S, L)  float32
  input_labels    (S, L)  int32     extended ids, IGNORE on non-loss slots
  token_type_ids  (S, L)  int32
  video_feature   (S, Lv, Dv) float32   (the reference pads features to L
                                         rows with zeros the model never
                                         reads — model.py:889 slices
                                         [:max_v_len]; we keep only Lv)
  step_mask       (S,)    float32
  ingr_ids        (I,)    int32
  ingr_mask       (I,)    int32
  ingr_sep_mask   (I,)    int32
  entity_mask     (E,)    float32
  copy_ids        (E, K)  int32     pointer-gen scatter targets (extended ids)
  copy_weights    (E, K)  float32   1/len(group) per occurrence
  oov_count       ()      int32
  alignment       (S, E)  float32   entity supervision
  action          (S, A)  float32   verb supervision (multi-hot)
  action_row_mask (S,)    float32   rows with >=1 active verb
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

from svpc_torch import tokenization as tok
from svpc_torch.config import Config
from svpc_torch.data.anet import load_annotations, load_durations
from svpc_torch.data.features import FeatureStore, index_clip_features

ARRAY_KEYS = (
    "input_ids", "input_mask", "input_labels", "token_type_ids",
    "video_feature", "step_mask", "ingr_ids", "ingr_mask", "ingr_sep_mask",
    "entity_mask", "copy_ids", "copy_weights", "oov_count",
    "alignment", "action", "action_row_mask",
)


@dataclasses.dataclass
class Example:
    arrays: Dict[str, np.ndarray]
    meta: Dict


Batch = Dict[str, np.ndarray]


def build_ingredient_arrays(
    ingredients: Sequence[str], vocab: tok.Vocabulary,
    max_i_len: int, max_entities: int, max_oov: int, max_ingr_words: int,
    strict: bool = True,
) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Tokenize ingredients; build OOV extension + pointer-gen scatter groups.

    Mirrors clip_ingredient_to_feature (recursive_caption_dataset.py:239-281):
    OOV ingredient words get ids ``vocab_size + k`` in first-seen order; the
    per-entity id groups drive the copy distribution scatter.

    ``strict=True`` (annotated training/eval splits, where the budgets were
    measured corpus-wide) raises on any budget overflow; ``strict=False``
    (GT-free inference on user-supplied ingredient specs) truncates with a
    warning instead — extra OOV words fall back to UNK, extra entities and
    extra per-ingredient words are dropped.
    """
    tokens, mask, sep_mask = tok.tokenize_ingredients(ingredients, max_i_len)
    ids = vocab.encode(tokens)

    vocab_size = len(vocab)
    oov_word_dict: Dict[str, int] = {}
    extended_ids: List[int] = []
    oov_overflow = 0
    for i, wid in enumerate(ids):
        if wid == tok.UNK:
            word = tokens[i]
            if word not in oov_word_dict:
                if not strict and len(oov_word_dict) >= max_oov:
                    oov_overflow += 1
                    extended_ids.append(tok.UNK)
                    continue
                oov_word_dict[word] = vocab_size + len(oov_word_dict)
            extended_ids.append(oov_word_dict[word])
        else:
            extended_ids.append(wid)
    if len(oov_word_dict) > max_oov:
        raise ValueError(
            f"example has {len(oov_word_dict)} OOV ingredient words "
            f"> max_oov={max_oov}")
    if oov_overflow:
        logger.warning(
            "ingredient spec has %d OOV word(s) beyond max_oov=%d; the "
            "extras stay [UNK] (not copyable)", oov_overflow, max_oov)

    # entity groups: ids between consecutive [SEP]s, stop at first [PAD]
    groups: List[List[int]] = []
    cur: List[int] = []
    for eid in extended_ids:
        if eid == tok.PAD:
            break
        if eid == tok.SEP:
            groups.append(cur)
            cur = []
        else:
            cur.append(eid)
    # NOTE: the reference keys groups by SEP count, so a trailing unterminated
    # group (ingredient cut by the max_i_len budget) still accumulates ids
    # under the next index — but that entity has no [SEP], hence no entity
    # slot; it can never be attended.  We drop it, matching effective
    # behaviour.

    n_entities = int(np.sum(sep_mask))
    if n_entities > max_entities:
        if strict:
            raise ValueError(
                f"example has {n_entities} entities > "
                f"max_entities={max_entities}")
        logger.warning(
            "ingredient spec has %d entities > max_entities=%d; keeping "
            "the first %d", n_entities, max_entities, max_entities)
        n_entities = max_entities

    copy_ids = np.zeros((max_entities, max_ingr_words), dtype=np.int32)
    copy_weights = np.zeros((max_entities, max_ingr_words), dtype=np.float32)
    for e, group in enumerate(groups[:max_entities]):
        if len(group) > max_ingr_words:
            if strict:
                raise ValueError(
                    f"ingredient group of {len(group)} words > "
                    f"max_ingr_words={max_ingr_words}")
            logger.warning(
                "ingredient group of %d words truncated to "
                "max_ingr_words=%d", len(group), max_ingr_words)
            group = group[:max_ingr_words]
        for k, eid in enumerate(group):
            copy_ids[e, k] = eid
            copy_weights[e, k] = 1.0 / len(group)

    entity_mask = np.zeros((max_entities,), dtype=np.float32)
    entity_mask[:n_entities] = 1.0

    arrays = dict(
        ingr_ids=np.asarray(ids, dtype=np.int32),
        ingr_mask=np.asarray(mask, dtype=np.int32),
        ingr_sep_mask=np.asarray(sep_mask, dtype=np.int32),
        entity_mask=entity_mask,
        copy_ids=copy_ids,
        copy_weights=copy_weights,
        oov_count=np.asarray(len(oov_word_dict), dtype=np.int32),
    )
    meta = dict(oov_word_dict=oov_word_dict, n_entities=n_entities)
    return arrays, meta


def build_clip_arrays(
    timestamp, sentence: str, raw_feat: np.ndarray, frm2sec: float,
    vocab: tok.Vocabulary, oov_word_dict: Dict[str, int],
    max_v_len: int, max_t_len: int,
    packed: Optional[Tuple[np.ndarray, int]] = None,
) -> Dict[str, np.ndarray]:
    """One clip-sentence pair -> fixed (L,) arrays.

    Token layout ``[CLS] [VID]* [SEP] [PAD]* | [BOS] w* [EOS] [PAD]*``
    (reference: recursive_caption_dataset.py:283-340).  ``packed`` carries
    a (features, valid_len) pair — features may be None (lazy pipeline:
    token arrays only, the feature bytes are filled straight into the
    batch buffer later); otherwise ``raw_feat`` is indexed here."""
    if packed is not None:
        feat, valid_l = packed
    else:
        feat, valid_l, _ = index_clip_features(
            raw_feat, timestamp, frm2sec, max_v_len, max_v_len)

    max_v_l = max_v_len - 2
    video_tokens = ([tok.CLS_TOKEN] + [tok.VID_TOKEN] * valid_l
                    + [tok.SEP_TOKEN] + [tok.PAD_TOKEN] * (max_v_l - valid_l))
    video_mask = [1] * (valid_l + 2) + [0] * (max_v_l - valid_l)

    text_tokens, text_mask = tok.tokenize_sentence(sentence, max_t_len)
    input_tokens = video_tokens + text_tokens

    input_ids = [vocab.get(t) for t in input_tokens]
    extended_input_ids = []
    for t in input_tokens:
        if t in vocab.word2idx:
            extended_input_ids.append(vocab.word2idx[t])
        elif t in oov_word_dict:
            extended_input_ids.append(oov_word_dict[t])
        else:
            extended_input_ids.append(tok.UNK)

    # shifted-right labels over the text span (recursive_caption_dataset.py:316-319)
    text_ext = extended_input_ids[-len(text_mask):]
    input_labels = (
        [tok.IGNORE] * len(video_tokens)
        + [tok.IGNORE if m == 0 else tid for tid, m in zip(text_ext, text_mask)][1:]
        + [tok.IGNORE]
    )
    input_mask = video_mask + text_mask
    token_type_ids = [0] * max_v_len + [1] * max_t_len

    out = dict(
        input_ids=np.asarray(input_ids, dtype=np.int32),
        input_labels=np.asarray(input_labels, dtype=np.int32),
        input_mask=np.asarray(input_mask, dtype=np.float32),
        token_type_ids=np.asarray(token_type_ids, dtype=np.int32),
    )
    if feat is not None:
        out["video_feature"] = feat
    return out


def resolve_feature_dir(base_dir: str, split: str) -> str:
    """Reference convention: features live under training/ (train split)
    and validation/ (val AND test splits) — train.py:630,638,
    test.py:297-303.  Falls back to the bare dir when no subdir exists."""
    subdir = "training" if split == "train" else "validation"
    feat_dir = os.path.join(base_dir, subdir)
    return feat_dir if os.path.isdir(feat_dir) else base_dir


class CaptionDataset:
    """YC2 recurrent captioning dataset producing fixed-shape examples."""

    def __init__(self, cfg: Config, split: str, num_steps: Optional[int] = None,
                 feature_store: Optional[FeatureStore] = None,
                 entries: Optional[List[dict]] = None,
                 lazy_features: bool = False):
        # lazy_features: examples carry a feature *reference* (paths +
        # clip spans, valid lengths from the .npy header) instead of the
        # materialized (S, Lv, D) array; batch builders fill the final
        # batch buffer directly.  The eager default keeps Example.arrays
        # complete.
        self.lazy_features = lazy_features
        m, d = cfg.model, cfg.data
        self.cfg = cfg
        self.split = split
        # reference: eval loaders raise max_n_sen by 10 (train.py:635-642)
        self.num_steps = num_steps or (
            m.max_n_sen if split == "train" else m.max_n_sen + 10)
        self.vocab = tok.Vocabulary.from_json(d.word2idx_path)
        import json
        with open(d.verb2idx_path) as f:
            self.verb2idx = json.load(f)
        self.action_vocab_size = len(self.verb2idx)
        self.store = feature_store or FeatureStore(
            resolve_feature_dir(d.video_feature_dir, split))
        self.frame_to_second = load_durations(
            d.duration_file, d.dset_name, d.sampling_sec)
        # ``entries`` bypasses the split files: caption new videos from a
        # user spec.  Annotated splits keep strict ingredient budgets
        # (measured corpus-wide); user specs truncate-with-warning instead.
        self._strict_budgets = entries is None
        data = (entries if entries is not None
                else load_annotations(d.data_dir, split, self.num_steps))
        self._dset_name = d.dset_name
        # fix_missing (recursive_caption_dataset.py:95-110)
        self.missing = [e["name"] for e in data
                        if not self.store.exists(self.video_name(e["name"]))]
        missing = set(self.missing)
        self.data = [e for e in data if e["name"] not in missing]
        # shrink the padded step axis to the split's actual maximum
        if self.data:
            self.num_steps = min(
                self.num_steps, max(len(e["sentences"]) for e in self.data))

    def video_name(self, name: str) -> str:
        from svpc_torch.data.anet import video_feature_name
        return video_feature_name(name, self._dset_name)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> Example:
        return self.make_example(self.data[index])

    def make_example(self, entry: dict) -> Example:
        m = self.cfg.model
        S = self.num_steps
        name = entry["name"]
        video_name = self.video_name(name)
        frm2sec = self.frame_to_second[video_name]

        ingr_arrays, ingr_meta = build_ingredient_arrays(
            entry["ingredients"], self.vocab, m.max_i_len,
            m.max_entities, m.max_oov, m.max_ingr_words,
            strict=self._strict_budgets)
        oov_word_dict = ingr_meta["oov_word_dict"]

        n_sen = len(entry["sentences"])
        L = m.max_v_len + m.max_t_len

        # lazy mode skips the feature bytes entirely: valid lengths come
        # from the .npy header + span math, and the batch builder fills
        # the final buffer later
        raw_feat = None
        valid_lens = None
        feature_ref = None
        if self.lazy_features:
            from svpc_torch.data.features import clip_valid_length
            feat_len = self.store.rows(video_name)
            valid_lens = np.array(
                [clip_valid_length(feat_len, entry["timestamps"][s],
                                   frm2sec, m.max_v_len)
                 for s in range(n_sen)], np.int64)
            feature_ref = dict(
                store=self.store, name=video_name,
                timestamps=np.asarray(entry["timestamps"][:n_sen],
                                      np.float64),
                frm2sec=frm2sec, valid=valid_lens,
                max_v_len=m.max_v_len,
                feature_size=m.video_feature_size)
        else:
            raw_feat = self.store.load(video_name)

        out = dict(
            input_ids=np.zeros((S, L), np.int32),
            input_labels=np.full((S, L), tok.IGNORE, np.int32),
            input_mask=np.zeros((S, L), np.float32),
            token_type_ids=np.zeros((S, L), np.int32),
        )
        if not self.lazy_features:
            out["video_feature"] = np.zeros(
                (S, m.max_v_len, m.video_feature_size), np.float32)
        for s in range(n_sen):
            clip_packed = ((None, int(valid_lens[s])) if self.lazy_features
                           else None)
            clip = build_clip_arrays(
                entry["timestamps"][s], entry["sentences"][s], raw_feat,
                frm2sec, self.vocab, oov_word_dict, m.max_v_len, m.max_t_len,
                packed=clip_packed)
            for k in out:
                out[k][s] = clip[k]

        step_mask = np.zeros((S,), np.float32)
        step_mask[:n_sen] = 1.0

        # entity / action supervision (recursive_caption_dataset.py:219-237)
        alignment = np.zeros((S, m.max_entities), np.float32)
        align_rows = entry.get("alignment", [])[:S]
        for i, row in enumerate(align_rows):
            w = min(len(row), m.max_entities)
            alignment[i, :w] = np.asarray(row[:w], np.float32)
        action = np.zeros((S, self.action_vocab_size), np.float32)
        for i, step_action in enumerate(entry.get("action", [])[:S]):
            for _, action_id in step_action.items():
                action[i, action_id] = 1.0
        action_row_mask = (action.sum(axis=1) > 0).astype(np.float32) * step_mask

        arrays = dict(out, step_mask=step_mask, alignment=alignment,
                      action=action, action_row_mask=action_row_mask,
                      **ingr_arrays)
        meta = dict(
            name=name,
            timestamps=entry["timestamps"],
            gt_sentences=entry["sentences"],
            oov_word_dict=oov_word_dict,
            n_steps=n_sen,
            n_entities=ingr_meta["n_entities"],
        )
        if feature_ref is not None:
            meta["feature_ref"] = feature_ref
        return Example(arrays=arrays, meta=meta)

    def work_key(self, index: int):
        """(max clip frames, step count): the two geometry drivers of a
        video's packed compute cost (video-span bucket x clip count)."""
        e = self.data[index]
        frm2sec = self.frame_to_second[self.video_name(e["name"])]
        n = min(len(e["sentences"]), self.num_steps)
        mx = max(int((ts[1] - ts[0]) / frm2sec) + 1
                 for ts in e["timestamps"][:n])
        return (min(mx, self.cfg.model.max_v_len - 2), n)

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, drop_remainder: bool = False,
                pad_to_batch: bool = True, length_group: int = 0,
                builder=None, skip: int = 0):
        """Yield (Batch, metas) pairs.

        The order is a permutation from ``RandomState(seed)`` when
        ``shuffle``.  ``skip`` drops the first N batches BEFORE any
        example or feature work (mid-epoch resume).  ``builder(examples,
        padded_batch_size) -> Batch`` replaces the dense stack (e.g.
        data/packing.pack_examples).  ``length_group=K`` (with shuffle)
        sorts each window of K*batch_size shuffled videos by ``work_key``
        before cutting batches, then shuffles the batch order."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        rng = np.random.RandomState(seed)
        order = np.arange(len(self))
        if shuffle:
            order = rng.permutation(order)
        if length_group and shuffle and len(order):
            window = max(batch_size, length_group * batch_size)
            batches = []
            for i in range(0, len(order), window):
                w = sorted(order[i:i + window],
                           key=lambda j: self.work_key(int(j)))
                batches.extend(w[j:j + batch_size]
                               for j in range(0, len(w), batch_size))
            rng.shuffle(batches)
        else:
            batches = [order[i:i + batch_size]
                       for i in range(0, len(order), batch_size)]
        if drop_remainder:
            # filter BEFORE skip, so skip counts yielded batches
            batches = [b for b in batches if len(b) == batch_size]
        for idx in batches[skip:]:
            examples = [self[int(j)] for j in idx]
            eff = batch_size if pad_to_batch else len(idx)
            if builder is not None:
                batch = builder(examples, eff)
            else:
                batch = batch_examples(examples)
                if eff > len(idx):
                    batch = pad_batch_to(batch, eff)
            yield batch, [e.meta for e in examples]


def inference_entries(spec: Dict[str, dict], max_n_sen: int) -> List[dict]:
    """User inference spec -> CaptionDataset entries (no ground truth).

    ``spec`` maps video id -> {"timestamps": [[start_s, end_s], ...],
    "ingredients": [str, ...]}; sentences are optional and default to
    empty (greedy/beam decode zeroes the text inputs regardless —
    reference translator.py:205-228)."""
    out = []
    for name, line in spec.items():
        ts = [list(t) for t in line["timestamps"]][:max_n_sen]
        if not ts:
            raise ValueError(f"{name}: needs at least one timestamp pair")
        sents = list(line.get("sentences") or [])[:len(ts)]
        sents += [""] * (len(ts) - len(sents))  # every clip gets decoded
        out.append(dict(name=name, timestamps=ts, sentences=sents,
                        ingredients=list(line["ingredients"])))
    return out


def fill_features_from_ref(ref: Dict, block: np.ndarray) -> None:
    """Fill ``block`` (n_rows >= n_clips, total_len, D; zeroed,
    C-contiguous f32) with the referenced video's clip features — the
    lazy pipeline's single feature copy."""
    if len(ref["timestamps"]) == 0:
        return
    from svpc_torch.data.features import fill_clip_features
    fill_clip_features(ref["store"].load(ref["name"]), ref["timestamps"],
                       ref["frm2sec"], ref["max_v_len"], block)


def batch_examples(examples: Sequence[Example]) -> Batch:
    out = {k: np.stack([e.arrays[k] for e in examples])
           for k in ARRAY_KEYS if k in examples[0].arrays}
    if "video_feature" not in out:
        # lazy pipeline: materialize the dense feature grid here
        refs = [e.meta["feature_ref"] for e in examples]
        S = examples[0].arrays["step_mask"].shape[0]
        feat = np.zeros((len(examples), S, refs[0]["max_v_len"],
                         refs[0]["feature_size"]), np.float32)
        for b, ref in enumerate(refs):
            fill_features_from_ref(ref, feat[b])
        out["video_feature"] = feat
    return out


def pad_batch_to(batch: Batch, batch_size: int) -> Batch:
    """Pad the leading axis with all-invalid examples (zero masks, IGNORE
    labels) so every batch has one static shape."""
    n = batch["step_mask"].shape[0]
    if n == batch_size:
        return batch
    out = {}
    for k, v in batch.items():
        pad_shape = (batch_size - n,) + v.shape[1:]
        if k == "input_labels":
            pad = np.full(pad_shape, tok.IGNORE, v.dtype)
        else:
            pad = np.zeros(pad_shape, v.dtype)
        out[k] = np.concatenate([v, pad], axis=0)
    return out

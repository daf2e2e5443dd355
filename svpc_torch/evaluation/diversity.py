"""Caption diversity statistics.

Equivalent of the reference's legacy densevid_eval/evaluateCaptionsDiversity.py
(anet-era, hard-coded paths; off the main path — SURVEY §2.2), re-designed
dataset-agnostic: novel-sentence ratio against the training corpus and
distinct-n-gram ratios (per video and overall).
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def _clean(sentence: str) -> str:
    s = sentence.lower()
    for ch in ",.:;!?\"@()[]<>`#":
        s = s.replace(ch, " ")
    s = s.replace("’", "'")
    return " ".join(s.split())


def _ngrams(words: Sequence[str], n: int) -> List[str]:
    return ["_".join(words[i:i + n]) for i in range(len(words) - n + 1)]


def diversity_stats(
    predictions: Dict[str, List[dict]],
    training_sentences: Sequence[str] = (),
) -> Dict[str, float]:
    """
    predictions: anet-format ``results`` ({vid: [{"sentence": ...}]})
    training_sentences: corpus to measure novelty against (optional).

    Returns:
      novel_sentence_ratio — fraction of generated sentences not present
        verbatim in the training corpus;
      unique_sentence_ratio — fraction of distinct generated sentences;
      distinct_1..distinct_4 — corpus-level distinct n-gram ratios;
      per_video_distinct_1..4 — averaged per-video distinct ratios.
    """
    train_set = {_clean(s) for s in training_sentences}
    all_sents: List[str] = []
    per_video = {n: [] for n in range(1, 5)}

    for vid, entries in predictions.items():
        vid_grams = {n: {} for n in range(1, 5)}
        for e in entries:
            s = _clean(e["sentence"])
            if not s:
                continue
            all_sents.append(s)
            words = s.split()
            for n in range(1, 5):
                for g in _ngrams(words, n):
                    vid_grams[n][g] = vid_grams[n].get(g, 0) + 1
        for n in range(1, 5):
            total = sum(vid_grams[n].values())
            per_video[n].append(
                len(vid_grams[n]) / total if total else 0.0)

    out: Dict[str, float] = {}
    if all_sents:
        out["unique_sentence_ratio"] = len(set(all_sents)) / len(all_sents)
        if train_set:
            novel = sum(1 for s in all_sents if s not in train_set)
            out["novel_sentence_ratio"] = novel / len(all_sents)
        corpus_words = [w for s in all_sents for w in s.split()]
        for n in range(1, 5):
            grams = _ngrams(corpus_words, n)
            out[f"distinct_{n}"] = len(set(grams)) / len(grams) if grams else 0.0
            out[f"per_video_distinct_{n}"] = (
                sum(per_video[n]) / len(per_video[n]) if per_video[n] else 0.0)
    return out

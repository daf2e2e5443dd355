"""tIoU-based dense-captioning evaluation.

Equivalent of the reference's legacy densevid_eval/evaluate.py (the 2017
ActivityNet dense-caption evaluator; python-2-era and off the main path —
SURVEY §2.2): for each tIoU threshold, every predicted (timestamp,
sentence) is scored against ground-truth segments whose temporal IoU
exceeds the threshold, and sentence metrics are averaged over thresholds.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from svpc_torch.evaluation.bleu import compute_bleu
from svpc_torch.evaluation.cider import compute_cider_d
from svpc_torch.evaluation.para_eval import parse_sent
from svpc_torch.evaluation.rouge import compute_rouge_l

DEFAULT_TIOUS = (0.3, 0.5, 0.7, 0.9)


def tiou(a: Sequence[float], b: Sequence[float]) -> float:
    inter = max(0.0, min(a[1], b[1]) - max(a[0], b[0]))
    union = max(a[1], b[1]) - min(a[0], b[0])
    return inter / union if union > 0 else 0.0


def evaluate_dense_captions(
    predictions: Dict[str, List[dict]],
    references: Dict[str, dict],
    tiou_thresholds: Sequence[float] = DEFAULT_TIOUS,
) -> Dict[str, float]:
    """
    predictions: {vid: [{"sentence", "timestamp"}]}
    references: {vid: {"timestamps": [[s,e]...], "sentences": [...]}}
    Returns Bleu_4 / ROUGE_L / CIDEr averaged over tIoU thresholds, plus
    average recall/precision of the localization matching.

    Aggregation follows the reference evaluator's SHAPE (evaluate.py:
    236-252): sentence metrics are computed PER GT VIDEO over its matched
    pairs and averaged over ALL GT videos, scoring 0 for videos with no
    valid pairs.  Two deliberate deviations from the shipped reference,
    whose evaluate_tiou is self-admittedly broken: its `if True or ...`
    (evaluate.py:194) bypasses the tIoU test entirely and pairs
    prediction i with GT sentence i ("for now we use gt proposal"), and
    unmatched predictions are scored against a literal 'abc123!@#'
    garbage reference (evaluate.py:206-210).  Here the tIoU matching is
    real and unmatched predictions simply contribute no pair (they still
    lower Precision).
    """
    out: Dict[str, float] = {}
    per_t_scores = []
    recalls, precisions = [], []
    for t in tiou_thresholds:
        vid_recalls, vid_precisions = [], []
        vid_metrics = []  # per GT video: {"Bleu_4", "ROUGE_L", "CIDEr"}
        # reference semantics (evaluate.py:126-157): iterate ALL ground
        # truth videos — a GT video with no predictions scores 0 recall
        # and 0 precision; tIoU comparison is strictly greater-than.
        # recall = covered GT segments / GT TIMESTAMP count
        # (evaluate.py:153), precision = covered predictions / prediction
        # count, each per video then averaged — a pile of predictions on
        # one GT segment cannot inflate recall.
        for vid, ref in references.items():
            preds = predictions.get(vid, [])
            gt_covered: set = set()
            pred_covered = 0
            gts, res = {}, {}
            for p in preds:
                matches = []
                hit = False
                for ri, ts in enumerate(ref["timestamps"]):
                    if tiou(p["timestamp"], ts) > t:
                        # localization coverage is by tIoU alone
                        # (evaluate.py:145-152) — a timestamp without a
                        # paired sentence still counts as covered ...
                        hit = True
                        gt_covered.add(ri)
                        if ri < len(ref["sentences"]):
                            # ... but only sentence-bearing segments can
                            # contribute a scoring pair
                            matches.append(ref["sentences"][ri])
                if hit:
                    pred_covered += 1
                if matches:
                    idx = len(res)
                    gts[idx] = [" ".join(parse_sent(m)) for m in matches]
                    res[idx] = [" ".join(parse_sent(p["sentence"]))]
            if ref["timestamps"]:
                vid_recalls.append(len(gt_covered) / len(ref["timestamps"]))
            vid_precisions.append(pred_covered / len(preds) if preds
                                  else 0.0)
            if res:
                bleu, _ = compute_bleu(gts, res)
                rouge, _ = compute_rouge_l(gts, res)
                cider, _ = compute_cider_d(gts, res)
                vid_metrics.append({"Bleu_4": bleu[3], "ROUGE_L": rouge,
                                    "CIDEr": cider})
            else:  # no valid pairs: the reference scores the video 0
                vid_metrics.append(
                    {"Bleu_4": 0.0, "ROUGE_L": 0.0, "CIDEr": 0.0})
        per_t_scores.append({
            key: float(np.mean([m[key] for m in vid_metrics]))
            if vid_metrics else 0.0
            for key in ("Bleu_4", "ROUGE_L", "CIDEr")})
        recalls.append(float(np.mean(vid_recalls)) if vid_recalls else 0.0)
        precisions.append(
            float(np.mean(vid_precisions)) if vid_precisions else 0.0)

    for key in ("Bleu_4", "ROUGE_L", "CIDEr"):
        out[key] = float(np.mean([s[key] for s in per_t_scores]))
    out["Recall"] = float(np.mean(recalls))
    out["Precision"] = float(np.mean(precisions))
    for t, s in zip(tiou_thresholds, per_t_scores):
        for key, v in s.items():
            out[f"{key}@tIoU{t}"] = v
    return out


def merge_dicts_by_prefix(paths_and_prefixes: Sequence[Tuple[str, str]],
                          out_path: str) -> dict:
    """Merge metric JSON files into one, namespacing each file's keys
    with its prefix.  Covers the use case of the reference's
    densevid_eval/merge_dicts_by_prefix.py (glob files -> one JSON) but
    is NOT key-compatible with it: the reference dict.update()s files
    together un-prefixed (later file wins on collisions) — here
    colliding keys from different files survive side by side."""
    import json
    merged = {}
    for path, prefix in paths_and_prefixes:
        with open(path) as f:
            d = json.load(f)
        for k, v in d.items():
            merged[f"{prefix}{k}"] = v
    with open(out_path, "w") as f:
        json.dump(merged, f, indent=2)
    return merged

"""Per-video n-gram repetition ratios re1..re4.

Faithful reimplementation of the reference's
densevid_eval/evaluateRepetition.py:52-114 (including its sentence
cleanup: strip trailing '.', strip trailing spaces, commas -> spaces,
collapse double spaces).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _ngram_counts(words: List[str], grams: List[Dict[str, int]]):
    for n in range(4):
        for i in range(len(words) - n):
            key = "_".join(words[i:i + n + 1])
            grams[n][key] = grams[n].get(key, 0) + 1


def evaluate_repetition(pred: Dict, gt: Dict) -> Dict[str, float]:
    res = {f"re{n}": [] for n in range(1, 5)}
    num_evaluated = 0
    for vid in gt:
        if vid not in pred:
            continue
        num_evaluated += 1
        grams = [dict(), dict(), dict(), dict()]
        for e in pred[vid]:
            s = e["sentence"]
            if not s:
                continue
            if s[-1] == ".":
                s = s[:-1]
            while s and s[-1] == " ":
                s = s[:-1]
            s = s.replace(",", " ")
            while "  " in s:
                s = s.replace("  ", " ")
            _ngram_counts(s.split(" "), grams)
        for n in range(4):
            total = float(sum(grams[n].values()))
            rep = float(sum(max(c - 1, 0) for c in grams[n].values()))
            res[f"re{n + 1}"].append(rep / total if total != 0 else 0)
    out = {k: float(np.mean(v)) if v else 0.0 for k, v in res.items()}
    out.update(num_pred=len(pred), num_gt=len(gt),
               num_evaluated=num_evaluated)
    return out

"""ROUGE-L, algorithmically faithful to pycocoevalcap's Rouge (beta=1.2)."""

from __future__ import annotations

from typing import Dict, List, Tuple


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(cur[j - 1], prev[j])
        prev = cur
    return prev[len(b)]


def calc_score(candidate: List[str], refs: List[str],
               beta: float = 1.2) -> float:
    prec, rec = [], []
    token_c = candidate[0].split()
    for reference in refs:
        token_r = reference.split()
        lcs = _lcs_len(token_r, token_c)
        prec.append(lcs / float(len(token_c)) if token_c else 0.0)
        rec.append(lcs / float(len(token_r)) if token_r else 0.0)
    prec_max = max(prec)
    rec_max = max(rec)
    if prec_max != 0 and rec_max != 0:
        return ((1 + beta ** 2) * prec_max * rec_max
                / float(rec_max + beta ** 2 * prec_max))
    return 0.0


def compute_rouge_l(gts: Dict, res: Dict) -> Tuple[float, List[float]]:
    """Per-id scores are ordered by ``sorted(gts, key=str)`` — see the
    compute_meteor docstring for the int-id alignment caveat."""
    ids = sorted(gts.keys(), key=str)
    if not ids:  # empty eval degrades like the sibling scorers
        return 0.0, []
    scores = [calc_score(res[i], gts[i]) for i in ids]
    return sum(scores) / len(scores), scores

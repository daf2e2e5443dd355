"""Corpus BLEU 1-4, algorithmically faithful to pycocoevalcap's BleuScorer
(the scorer invoked by the reference's densevid_eval/para-evaluate.py:55-60).

Same 'closest' reference-length selection, same tiny/small guard constants,
same brevity penalty applied to the corpus totals.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


def _precook(s: str, n: int = 4):
    words = s.split()
    counts: Dict[tuple, int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return len(words), counts


def _cook_refs(refs: Sequence[str], n: int = 4):
    reflen = []
    maxcounts: Dict[tuple, int] = {}
    for ref in refs:
        rl, counts = _precook(ref, n)
        reflen.append(rl)
        for ngram, count in counts.items():
            maxcounts[ngram] = max(maxcounts.get(ngram, 0), count)
    return reflen, maxcounts


def _cook_test(test: str, reflen_counts, n: int = 4):
    reflen, refmaxcounts = reflen_counts
    testlen, counts = _precook(test, n)
    result = {"testlen": testlen}
    # closest ref length
    result["reflen"] = min(reflen, key=lambda rl: (abs(rl - testlen), rl))
    result["guess"] = [max(0, testlen - k + 1) for k in range(1, n + 1)]
    result["correct"] = [0] * n
    for ngram, count in counts.items():
        result["correct"][len(ngram) - 1] += min(
            refmaxcounts.get(ngram, 0), count)
    return result


def compute_bleu(gts: Dict, res: Dict, n: int = 4
                 ) -> Tuple[List[float], List[List[float]]]:
    """gts: {id: [ref strings]}, res: {id: [hyp string]}.
    Returns (corpus scores [BLEU1..4], per-id scores).

    Per-id scores are ordered by ``sorted(gts, key=str)`` — see the
    compute_meteor docstring for the int-id alignment caveat."""
    small = 1e-9
    tiny = 1e-15

    totalcomps = {"testlen": 0, "reflen": 0,
                  "guess": [0] * n, "correct": [0] * n}
    per_id_scores: List[List[float]] = [[] for _ in range(n)]

    for vid in sorted(gts.keys(), key=str):
        refs = _cook_refs(gts[vid], n)
        comps = _cook_test(res[vid][0], refs, n)
        testlen, reflen = comps["testlen"], comps["reflen"]
        totalcomps["testlen"] += testlen
        totalcomps["reflen"] += reflen
        for k in range(n):
            totalcomps["guess"][k] += comps["guess"][k]
            totalcomps["correct"][k] += comps["correct"][k]
        # per-sentence score
        bleu = 1.0
        for k in range(n):
            bleu *= (comps["correct"][k] + tiny) / (comps["guess"][k] + small)
            bleu_k = bleu ** (1.0 / (k + 1))
            ratio = (testlen + tiny) / (reflen + small)
            if ratio < 1:
                bleu_k *= math.exp(1 - 1 / ratio)
            per_id_scores[k].append(bleu_k)

    corpus = []
    bleu = 1.0
    testlen, reflen = totalcomps["testlen"], totalcomps["reflen"]
    for k in range(n):
        bleu *= (totalcomps["correct"][k] + tiny) \
            / (totalcomps["guess"][k] + small)
        bleu_k = bleu ** (1.0 / (k + 1))
        ratio = (testlen + tiny) / (reflen + small)
        if ratio < 1:
            bleu_k *= math.exp(1 - 1 / ratio)
        corpus.append(bleu_k)
    return corpus, per_id_scores

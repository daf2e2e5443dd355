"""CIDEr-D, algorithmically faithful to pycocoevalcap's CiderScorer
(n=4, sigma=6.0): tf-idf n-gram vectors with document frequency computed
over the reference corpus, count clipping, gaussian length penalty,
mean over n, scaled by 10.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

from svpc_torch.evaluation.bleu import _precook as _bleu_precook


def _precook(s: str, n: int = 4):
    # shared n-gram counting with bleu.py (one source of truth); CIDEr
    # only needs the counts
    return _bleu_precook(s, n)[1]


def compute_cider_d(gts: Dict, res: Dict, n: int = 4, sigma: float = 6.0
                    ) -> Tuple[float, List[float]]:
    """Per-id scores are ordered by ``sorted(gts, key=str)`` — see the
    compute_meteor docstring for the int-id alignment caveat."""
    ids = sorted(gts.keys(), key=str)
    if not ids:  # empty eval degrades like bleu/rouge (0, not log(0) NaN)
        return 0.0, []
    crefs = [[_precook(r) for r in gts[i]] for i in ids]
    ctest = [_precook(res[i][0]) for i in ids]

    # document frequency over reference sets
    df: Dict[tuple, float] = defaultdict(float)
    for refs in crefs:
        for ngram in set(ng for ref in refs for ng in ref.keys()):
            df[ngram] += 1
    log_ref_len = np.log(float(len(crefs)))

    def counts2vec(cnts):
        vec = [defaultdict(float) for _ in range(n)]
        length = 0
        norm = [0.0] * n
        for ngram, term_freq in cnts.items():
            d = np.log(max(1.0, df[ngram]))
            k = len(ngram) - 1
            vec[k][ngram] = float(term_freq) * (log_ref_len - d)
            norm[k] += vec[k][ngram] ** 2
            if k == 0:
                length += term_freq
        norm = [np.sqrt(v) for v in norm]
        return vec, norm, length

    def sim(vec_hyp, vec_ref, norm_hyp, norm_ref, len_hyp, len_ref):
        delta = float(len_hyp - len_ref)
        val = np.zeros(n)
        for k in range(n):
            for ngram, count in vec_hyp[k].items():
                val[k] += min(count, vec_ref[k][ngram]) * vec_ref[k][ngram]
            if norm_hyp[k] != 0 and norm_ref[k] != 0:
                val[k] /= (norm_hyp[k] * norm_ref[k])
            val[k] *= np.e ** (-(delta ** 2) / (2 * sigma ** 2))
        return val

    scores = []
    for test, refs in zip(ctest, crefs):
        vec, norm, length = counts2vec(test)
        score = np.zeros(n)
        for ref in refs:
            vec_ref, norm_ref, length_ref = counts2vec(ref)
            score += sim(vec, vec_ref, norm, norm_ref, length, length_ref)
        score_avg = np.mean(score) / len(refs) * 10.0
        scores.append(float(score_avg))
    return float(np.mean(scores)), scores

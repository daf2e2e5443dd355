"""Decode postprocessing: ids -> sentences -> submission JSON.

Reference: translate.py:20-93 (consecutive-duplicate removal, timestamp
sort, anet-format submission structure).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from svpc_torch.tokenization import Vocabulary


def remove_duplicate_words(sentence: str) -> str:
    """Collapse consecutive duplicate words (reference translate.py:27-42)."""
    words = sentence.split(" ")
    out = [words[0]]
    for w in words[1:]:
        if w != out[-1]:
            out.append(w)
    return " ".join(out)


def batch_to_sentences(
    token_ids: np.ndarray, metas: Sequence[dict], vocab: Vocabulary,
) -> List[List[str]]:
    """(B, S, T) ids -> per-example lists of postprocessed sentences
    (only the real steps of each example)."""
    out = []
    for b, meta in enumerate(metas):
        sents = []
        for s in range(meta["n_steps"]):
            sent = vocab.convert_ids_to_sentence(
                token_ids[b, s].tolist(), meta.get("oov_word_dict", {}))
            sent = remove_duplicate_words(sent)
            sent = sent.encode("ascii", "ignore").decode()
            sents.append(sent)
        out.append(sents)
    return out


def nbest_entries(tokens: np.ndarray, scores: np.ndarray,
                  metas: Sequence[dict], vocab: Vocabulary):
    """Ranked hypotheses (B, n, S, T) with their scores (B, n, S) ->
    (the rank-0 sentences as ``batch_to_sentences`` gives them, and per
    example and real step ``{"nbest": [{"sentence", "score"}, ...]}``
    best-first): the one construction of serving's payloads and of the
    offline n-best submission."""
    n = tokens.shape[1]
    per_rank = [batch_to_sentences(tokens[:, r], metas, vocab)
                for r in range(n)]
    nbest = [[{"nbest": [{"sentence": per_rank[r][b][s],
                          "score": float(scores[b, r, s])}
                         for r in range(n)]}
              for s in range(meta["n_steps"])]
             for b, meta in enumerate(metas)]
    return per_rank[0], nbest


def build_submission(results: Dict[str, List[dict]]) -> dict:
    """anet-format submission JSON (reference translate.py:47-49, 92)."""
    return {
        "version": "VERSION 1.0",
        "results": {k: sorted(v, key=lambda x: float(x["timestamp"][0]))
                    for k, v in results.items()},
        "external_data": {"used": "true", "details": "ay"},
    }


def collect_results(sentences: List[List[str]], metas: Sequence[dict],
                    results: Optional[Dict[str, List[dict]]] = None,
                    extras: Optional[List[List[dict]]] = None):
    """Accumulate one batch's sentences into a submission results dict.
    ``extras`` (the [example][step] structure of ``sentences``) merges
    more fields into each entry, e.g. the ``nbest`` hypothesis lists."""
    if results is None:
        results = defaultdict(list)
    for b, (sents, meta) in enumerate(zip(sentences, metas)):
        for s, sent in enumerate(sents):
            entry = {"sentence": sent,
                     "timestamp": meta["timestamps"][s],
                     "gt_sentence": meta["gt_sentences"][s]}
            if extras is not None:
                entry.update(extras[b][s])
            results[meta["name"]].append(entry)
    return results

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


def build_submission(results: Dict[str, List[dict]]) -> dict:
    """anet-format submission JSON (reference translate.py:47-49, 92)."""
    return {
        "version": "VERSION 1.0",
        "results": {k: sorted(v, key=lambda x: float(x["timestamp"][0]))
                    for k, v in results.items()},
        "external_data": {"used": "true", "details": "ay"},
    }


def collect_results(sentences: List[List[str]], metas: Sequence[dict],
                    results: Optional[Dict[str, List[dict]]] = None):
    """Accumulate one batch's sentences into a submission results dict."""
    if results is None:
        results = defaultdict(list)
    for sents, meta in zip(sentences, metas):
        for s, sent in enumerate(sents):
            results[meta["name"]].append({
                "sentence": sent,
                "timestamp": meta["timestamps"][s],
                "gt_sentence": meta["gt_sentences"][s]})
    return results

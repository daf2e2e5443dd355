"""Vocab-size / sentence-length statistics
(reference densevid_eval/get_caption_stat.py:31-38)."""

from __future__ import annotations

from typing import Dict, List

from svpc_torch.tokenization import word_tokenize


def get_sen_stat(sentences: List[str]) -> Dict[str, float]:
    tokenized = [word_tokenize(s.lower()) for s in sentences]
    lengths = [len(e) for e in tokenized]
    vocab = set(w for t in tokenized for w in t)
    return {
        "vocab_size": len(vocab),
        "avg_sen_len": 1.0 * sum(lengths) / max(len(lengths), 1),
        "num_sen": len(sentences),
    }


def caption_stats(pred: Dict, gt_vids: Dict) -> Dict:
    sub = {k: v for k, v in pred.items() if k in gt_vids}
    entries = [e for v in sub.values() for e in v]
    out = {"submission": get_sen_stat([e["sentence"] for e in entries])}
    if entries and "gt_sentence" in entries[0]:
        out["gt_stat"] = get_sen_stat([e["gt_sentence"] for e in entries])
    return out

"""Paragraph-level caption evaluation harness.

Equivalent of the reference's per-epoch eval subprocess chain
(train.py:308-331): densevid_eval/para-evaluate.py (BLEU/METEOR/ROUGE-L/
CIDEr on '. '-joined paragraphs normalized by parse_sent), plus
get_caption_stat.py and evaluateRepetition.py, merged into one metrics
dict.  Scorers are in-process pure python (see bleu/cider/rouge/meteor
modules); when the reference's densevid_eval tooling is present on disk it
can be invoked as a subprocess cross-check.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List

from svpc_torch.evaluation.bleu import compute_bleu
from svpc_torch.evaluation.caption_stats import caption_stats
from svpc_torch.evaluation.cider import compute_cider_d
from svpc_torch.evaluation.meteor import compute_meteor
from svpc_torch.evaluation.repetition import evaluate_repetition
from svpc_torch.evaluation.rouge import compute_rouge_l


def parse_sent(sent: str) -> List[str]:
    """densevid_eval/para-evaluate.py:26-29."""
    res = re.sub("[^a-zA-Z]", " ", sent)
    return res.strip().lower().split()


def _ensure_caption_key(data: Dict) -> Dict:
    """'v_'-prefix ids PER KEY.  The reference decides from the first key
    only (para-evaluate.py:67-68), so a legal YouTube id that itself
    starts with 'v_' would flip the whole dict's keying and silently zero
    every language score; per-key normalization keeps predictions and
    references consistent whatever mix arrives."""
    return {k if str(k).startswith("v_") else "v_" + str(k): v
            for k, v in data.items()}


def submission_to_paragraphs(results: Dict) -> Dict[str, str]:
    """{vid: [{sentence,...}]} -> {vid: 'sent1. sent2. '}
    (para-evaluate.py:76-84)."""
    para = {}
    for vid, infos in results.items():
        para[vid] = ""
        for info in infos:
            para[vid] += info["sentence"] + ". "
    return _ensure_caption_key(para)


def evaluate_language(results: Dict, reference_paragraphs,
                      include_meteor: bool = True) -> Dict[str, float]:
    """Paragraph-level BLEU1-4 / METEOR / ROUGE_L / CIDEr.

    ``reference_paragraphs`` is one {vid: paragraph} dict or a list of
    them — multiple dicts become a multi-reference list per video over
    the UNION of their vids (para-evaluate.py:114-122; anet ships two
    human references per split, yc2 one)."""
    predictions = submission_to_paragraphs(results)
    refs = (reference_paragraphs
            if isinstance(reference_paragraphs, list)
            else [reference_paragraphs])
    refs = [_ensure_caption_key(r) for r in refs]

    vids = list(dict.fromkeys(k for r in refs for k in r))
    gts = {i: [" ".join(parse_sent(r[k])) for r in refs if k in r]
           for i, k in enumerate(vids)}
    res = {
        i: [" ".join(parse_sent(predictions[k]))]
        if k in predictions and len(predictions[k]) > 0 else [""]
        for i, k in enumerate(vids)
    }

    out: Dict[str, float] = {}
    bleu, _ = compute_bleu(gts, res)
    for n, score in enumerate(bleu, start=1):
        out[f"Bleu_{n}"] = score
    out["ROUGE_L"], _ = compute_rouge_l(gts, res)
    out["CIDEr"], _ = compute_cider_d(gts, res)
    if include_meteor:
        meteor, _, backend = compute_meteor(gts, res)
        out["METEOR"] = meteor
        out["METEOR_backend"] = backend
    return out


def evaluate_submission(
    submission: Dict, reference_para_path,
    include_meteor: bool = True,
) -> Dict:
    """Full metric bundle for one submission dict
    ({"results": {vid: [...]}} anet format).  ``reference_para_path`` is
    one path or a list of paths (multi-reference, reference
    src/test.py:85-94)."""
    results = submission["results"] if "results" in submission else submission
    paths = (reference_para_path
             if isinstance(reference_para_path, list)
             else [reference_para_path])
    ref_paras = []
    for p in paths:
        with open(p) as f:
            ref_paras.append(json.load(f))

    metrics = evaluate_language(results, ref_paras, include_meteor)
    # repetition/caption-stats are single-reference tools in the
    # reference chain (train.py:308-331) — score against the first file
    gt_vids = ref_paras[0]
    metrics.update(evaluate_repetition(results, gt_vids))
    stats = caption_stats(results, gt_vids)
    metrics["submission_stat"] = stats.get("submission")
    if "gt_stat" in stats:
        metrics["gt_stat"] = stats["gt_stat"]
    return metrics

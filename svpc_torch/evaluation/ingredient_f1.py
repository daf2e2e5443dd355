"""Ingredient-prediction F1 by string matching in generated sentences.

Faithful reimplementation of the reference's
src/calculate_ingredient_f1.py:6-59: per-step ingredient extraction via
(a) substring match against the recipe's ingredient list and (b) per-word
match against the cross-corpus ingredient dictionary; then micro P/R/F1
against the same extraction over GT sentences.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Set


def build_ingredient_dictionary(data_dir: str) -> Set[str]:
    """Union of ingredient strings over all splits
    (calculate_ingredient_f1.py:61-73)."""
    from svpc_torch.data.anet import SPLIT_FILES
    all_ingredients: Set[str] = set()
    for fn in SPLIT_FILES.values():
        with open(os.path.join(data_dir, fn)) as f:
            data = json.load(f)
        for ann in data.values():
            all_ingredients.update(ann["ingredients"])
    return all_ingredients


def extract_step_ingredients(
    sentences: Sequence[str], ingredient_list: Sequence[str],
    all_ingredient_dict: Set[str],
) -> List[List[str]]:
    step_lists = []
    for sentence in sentences:
        step: List[str] = []
        for ingredient in ingredient_list:
            if ingredient in sentence:
                step.append(ingredient)
        for word in sentence.split(" "):
            if word in ingredient_list:
                continue
            if word in all_ingredient_dict:
                step.append(word)
        step_lists.append(step)
    return step_lists


def ingredient_f1(
    gt_recipes: Dict[str, dict], gen_recipes: Dict[str, dict],
    all_ingredient_dict: Set[str],
) -> Dict[str, float]:
    """Each recipe dict: {"ingredients": [...], "sentences": [...]}.
    Reproduces the micro-averaged counting of
    calculate_ingredient_f1.py:32-59 (every generated occurrence that
    appears in the GT step's list counts as correct)."""
    correct = recall_total = precision_total = 0
    for rid, gen in gen_recipes.items():
        gt = gt_recipes[rid]
        gt_steps = extract_step_ingredients(
            gt["sentences"], gt["ingredients"], all_ingredient_dict)
        gen_steps = extract_step_ingredients(
            gen["sentences"], gen["ingredients"], all_ingredient_dict)
        for gen_ings, gt_ings in zip(gen_steps, gt_steps):
            for g in gen_ings:
                if g in gt_ings:
                    correct += 1
            recall_total += len(gt_ings)
            precision_total += len(gen_ings)
    recall = correct / recall_total if recall_total else 0.0
    precision = correct / precision_total if precision_total else 0.0
    f1 = (2 * recall * precision / (recall + precision)
          if recall + precision else 0.0)
    return {"recall": recall, "precision": precision, "f1": f1}


def score_submission_file(caption_path: str, data_dir: str,
                          split: str = "test") -> Dict[str, float]:
    """Score an anet-format submission JSON ({"results": {vid: [{sentence,
    ...}]}}) against the split's GT — the reference's standalone entry
    point (calculate_ingredient_f1.py:74-105)."""
    from svpc_torch.data.anet import SPLIT_FILES
    with open(os.path.join(data_dir, SPLIT_FILES[split])) as f:
        gt_data = json.load(f)
    gt = {rid: {"ingredients": a["ingredients"], "sentences": a["sentences"]}
          for rid, a in gt_data.items()}
    with open(caption_path) as f:
        sub = json.load(f)
    gen = {rid: {"ingredients": gt[rid]["ingredients"],
                 "sentences": [o["sentence"] for o in outs]}
           for rid, outs in sub["results"].items() if rid in gt}
    return ingredient_f1(gt, gen, build_ingredient_dictionary(data_dir))


def main():
    import argparse
    p = argparse.ArgumentParser(
        description="Standalone ingredient-F1 scoring of a prediction JSON "
                    "(mirrors src/calculate_ingredient_f1.py)")
    p.add_argument("--model_name", default="model",
                   help="label for the printed result")
    p.add_argument("--caption_path", required=True,
                   help="anet-format submission JSON")
    p.add_argument("--data_dir", default="densevid_eval/yc2_data")
    p.add_argument("--split", default="test")
    args = p.parse_args()
    scores = score_submission_file(args.caption_path, args.data_dir,
                                   args.split)
    print(f"{args.model_name}: recall {scores['recall']:.4f} "
          f"precision {scores['precision']:.4f} f1 {scores['f1']:.4f}")


if __name__ == "__main__":
    main()

"""Offline evaluation CLI: the port of svpc_tpu/cli/evaluate.py (reference
src/test.py + scripts/eval_caption.sh).

Decodes a split from a checkpoint of the port's trainer (or, with
``--torch_checkpoint``, a reference ``.chkpt``), writes the submission JSON
and the merged metric bundle (BLEU@1-4, METEOR with its backend label,
ROUGE-L, CIDEr-D, re1-re4, caption statistics), optionally ingredient F1.

    python -m svpc_torch.cli.evaluate --model_type vivt \
      --data_dir DIR --video_feature_dir DIR --duration_file CSV \
      --word2idx_path JSON --verb2idx_path JSON \
      --checkpoint run/checkpoint_best --split test --output_dir out \
      [--use_beam --beam_size 2 [--n_best 2]] [--ingredient_f1]

Writes ``{greedy,beam{K},beam{K}_n{n}}_pred_{split}.json`` and
``metrics_{split}.json`` under ``--output_dir``.  Runs on the card unless
``--device cpu``.  On a mesh (``torchrun --nproc_per_node D*T -m
svpc_torch.cli.evaluate ... --dp_size D --tp_size T``) each rank holds its
tp shards and decodes its dp block of every batch; the tokens are
gathered, every rank scores the same submission and rank 0 writes.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from svpc_torch.cli.common import (add_common_args, add_mesh_args,
                                   config_from_args, load_eval_model,
                                   reject_pp)
from svpc_torch.data.anet import SPLIT_FILES, para_reference_files
from svpc_torch.data.pipeline import CaptionDataset
from svpc_torch.evaluation import evaluate_submission
from svpc_torch.evaluation.ingredient_f1 import (build_ingredient_dictionary,
                                                 ingredient_f1)
from svpc_torch.precision import resolve_device
from svpc_torch.parallel.mesh import rank_device
from svpc_torch.train.loop import mesh_for, run_greedy_eval, run_nbest_eval

logger = logging.getLogger(__name__)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(p)
    add_mesh_args(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--val_batch_size", type=int, default=50,
                   help="videos per decode batch (capped at the split)")
    p.add_argument("--ingredient_f1", action="store_true")
    p.add_argument("--use_beam", action="store_true",
                   help="beam search (the reference's flag silently falls "
                        "back to greedy)")
    p.add_argument("--beam_size", type=int, default=2)
    p.add_argument("--n_best", type=int, default=1,
                   help="with --use_beam: keep the top-n ranked hypotheses "
                        "per step in the submission (reference "
                        "train.py:546-548 surface)")
    p.add_argument("--torch_checkpoint", action="store_true",
                   help="--checkpoint is a reference PyTorch .chkpt file")
    return p


def ingredient_f1_of(submission: dict, data_dir: str, split: str) -> dict:
    """Ingredient F1 of a submission against its split's annotations, over
    the ingredient dictionary of all three splits."""
    with open(os.path.join(data_dir, SPLIT_FILES[split])) as f:
        gt = json.load(f)
    gt_recipes, gen_recipes = {}, {}
    for rid, ann in gt.items():
        if rid not in submission["results"]:
            continue
        gt_recipes[rid] = dict(ingredients=ann["ingredients"],
                               sentences=ann["sentences"])
        gen_recipes[rid] = dict(
            ingredients=ann["ingredients"],
            sentences=[e["sentence"] for e in submission["results"][rid]])
    return ingredient_f1(gt_recipes, gen_recipes,
                         build_ingredient_dictionary(data_dir))


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-10s: %(message)s")
    p = _parser()
    args = p.parse_args(argv)
    reject_pp(args, p)
    if args.n_best > 1 and not args.use_beam:
        p.error("--n_best > 1 requires --use_beam (greedy decode yields "
                "a single hypothesis)")
    if args.use_beam and args.beam_size < 2:
        p.error("--use_beam requires --beam_size >= 2 (beam_size 1 IS "
                "greedy decode — drop --use_beam)")
    if args.use_beam and args.n_best > args.beam_size:
        p.error(f"--n_best {args.n_best} cannot exceed "
                f"--beam_size {args.beam_size} (a beam of K carries only "
                "K ranked hypotheses)")
    cfg = config_from_args(args).replace_train(
        val_batch_size=args.val_batch_size)
    mesh = mesh_for(cfg, args.device)
    device = (resolve_device(args.device) if mesh is None
              else rank_device(args.device))
    main_rank = mesh is None or mesh.is_main
    cfg, model, ds = load_eval_model(
        cfg, args, lambda c: CaptionDataset(c, args.split,
                                            lazy_features=True))
    model = model.shard(mesh).to(device)
    os.makedirs(args.output_dir, exist_ok=True)

    if args.use_beam and args.n_best > 1:
        submission = run_nbest_eval(model, ds, cfg, beam_size=args.beam_size,
                                    n_best=args.n_best)
        decode_name = f"beam{args.beam_size}_n{args.n_best}"
    else:
        submission = run_greedy_eval(
            model, ds, cfg, beam_size=args.beam_size if args.use_beam else 0)
        decode_name = f"beam{args.beam_size}" if args.use_beam else "greedy"
    sub_path = os.path.join(args.output_dir,
                            f"{decode_name}_pred_{args.split}.json")
    if main_rank:
        with open(sub_path, "w") as f:
            json.dump(submission, f, indent=2)
        logger.info("submission written to %s", sub_path)

    metrics = {}
    ref_paths = [os.path.join(cfg.data.data_dir, f)
                 for f in para_reference_files(cfg.data.dset_name,
                                               args.split)]
    ref_paths = [r for r in ref_paths if os.path.exists(r)]
    if ref_paths:
        metrics = evaluate_submission(submission, ref_paths)
    if args.ingredient_f1:
        metrics["ingredient_f1"] = ingredient_f1_of(
            submission, cfg.data.data_dir, args.split)

    metrics_path = os.path.join(args.output_dir, f"metrics_{args.split}.json")
    if main_rank:
        with open(metrics_path, "w") as f:
            json.dump(metrics, f, indent=2, default=str)
    logger.info("metrics: %s", json.dumps(
        {k: v for k, v in metrics.items() if isinstance(v, (int, float))},
        indent=2))
    return dict(submission=submission, metrics=metrics,
                submission_path=sub_path, metrics_path=metrics_path,
                cfg=cfg)


if __name__ == "__main__":
    from svpc_torch.parallel.mesh import close_distributed

    main()
    close_distributed()

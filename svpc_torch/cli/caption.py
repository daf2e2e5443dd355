"""Caption NEW videos from a checkpoint, with no ground-truth annotations:
the port of svpc_tpu/cli/caption.py.

The user supplies a spec JSON

    {"<video_id>": {"timestamps": [[start_s, end_s], ...],
                    "ingredients": ["olive oil", "chicken breast", ...]},
     ...}

plus the feature files ``<video_id>_resnet.npy`` / ``<video_id>_bn.npy``
and the duration CSV row for each video, and gets the generated sentence
per clip.

    python -m svpc_torch.cli.caption --model_type vivt ... \
        --checkpoint run/checkpoint_best --input_json videos.json \
        --output captions.json [--use_beam --beam_size 2]

``--checkpoint`` is a checkpoint of the port's trainer or, with
``--torch_checkpoint``, a reference ``.chkpt``.  Runs on the card unless
``--device cpu``.  The common mesh flags are taken as svpc_tpu's CLI
takes them: ``--dp_size`` / ``--tp_size`` are accepted and no mesh is
built (one process decodes), ``--pp_size`` > 1 is refused.
"""

from __future__ import annotations

import argparse
import json
import logging

from svpc_torch.cli.common import (add_common_args, add_mesh_args,
                                   config_from_args, load_eval_model,
                                   reject_pp)
from svpc_torch.data.pipeline import CaptionDataset, inference_entries
from svpc_torch.precision import resolve_device
from svpc_torch.train.loop import run_greedy_eval

logger = logging.getLogger(__name__)


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-10s: %(message)s")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(p)
    add_mesh_args(p)
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input_json", required=True,
                   help="spec: {vid: {timestamps, ingredients}}")
    p.add_argument("--output", required=True, help="output captions JSON")
    p.add_argument("--val_batch_size", type=int, default=50,
                   help="videos per decode batch (capped at the spec)")
    p.add_argument("--use_beam", action="store_true")
    p.add_argument("--beam_size", type=int, default=2)
    p.add_argument("--torch_checkpoint", action="store_true",
                   help="--checkpoint is a reference PyTorch .chkpt file")
    args = p.parse_args(argv)
    reject_pp(args, p)
    device = resolve_device(args.device)
    cfg = config_from_args(args).replace_train(
        val_batch_size=args.val_batch_size)
    with open(args.input_json) as f:
        spec = json.load(f)
    if not spec:
        raise SystemExit(f"{args.input_json} is empty — expected "
                         "{video_id: {timestamps, ingredients}}")
    entries = inference_entries(spec, cfg.model.max_n_sen)

    def make_ds(c):
        ds = CaptionDataset(c, "infer", entries=entries, lazy_features=True)
        if ds.missing:
            raise SystemExit(
                f"missing feature files for: {', '.join(ds.missing)} "
                f"(need <vid>_resnet.npy + <vid>_bn.npy under "
                f"{c.data.video_feature_dir})")
        # a video with feature files but no duration row would otherwise
        # die with a bare KeyError inside make_example
        no_dur = [e["name"] for e in ds.data
                  if ds.video_name(e["name"]) not in ds.frame_to_second]
        if no_dur:
            raise SystemExit(
                f"no duration row for: {', '.join(no_dur)} in "
                f"{c.data.duration_file}")
        return ds

    cfg, model, ds = load_eval_model(cfg, args, make_ds)
    submission = run_greedy_eval(
        model.to(device), ds, cfg,
        beam_size=args.beam_size if args.use_beam else 0)
    # the user-facing payload: no gt_sentence
    out = {vid: [{"timestamp": e["timestamp"], "sentence": e["sentence"]}
                 for e in clips]
           for vid, clips in submission["results"].items()}
    with open(args.output, "w") as f:
        json.dump(out, f, indent=2)
    logger.info("captions for %d video(s) written to %s", len(out),
                args.output)
    return out


if __name__ == "__main__":
    main()

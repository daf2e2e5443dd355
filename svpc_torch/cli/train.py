"""Training CLI: the port of svpc_tpu/cli/train.py.

    python -m svpc_torch.cli.train --model_type vivt \
      --data_dir DIR --video_feature_dir DIR --duration_file CSV \
      --word2idx_path JSON --verb2idx_path JSON --workdir results/run1

Runs on the card unless ``--device cpu``.  Writes ``train.log.csv``,
``valid.log.csv`` (with the language metrics),
``greedy_pred_val_epoch{e}.json``, ``checkpoint_last`` (+
``.progress.json``), ``checkpoint_best`` (the epoch of the highest
validation CIDEr; of the lowest validation loss under
``--no_language_eval``) and ``history.json`` under ``--workdir``;
``--resume_from <workdir>/checkpoint_last`` continues a run, inside its
epoch when the checkpoint was taken mid-epoch.  TensorBoard scalars land
in ``--workdir`` too (``--no_tensorboard``: csv logs only), and
``--profile_steps N`` writes a ``torch.profiler`` trace of N steady-state
host batches to ``<workdir>/profile/trace.json``.

Data-, pipeline- and tensor-parallel (one process a rank, rank 0
writing)::

    torchrun --nproc_per_node N -m svpc_torch.cli.train ... \
      --dp_size D --pp_size P --tp_size T [--pp_microbatches K] \
      [--zero1] [--multihost_sharded_data]

with N = D * P * T; each rank runs on ``cuda:LOCAL_RANK`` over NCCL (gloo
with ``--device cpu``; ``--device cuda:0`` puts every rank on one card,
over gloo).  ``--pp_size P`` cuts the clip encoder's and the decoder's
layers into P stages (P must divide ``--num_hidden_layers``), each rank
holding only its stage's layers, their Adam moments and EMA, and runs
them on svpc_tpu's GPipe schedule of K microbatches (0: 2 * P).  Across
hosts torchrun's own rendezvous does what svpc_tpu's ``--multihost`` does
(``--nnodes``, ``--node_rank``, ``--rdzv_endpoint``); no flag of this CLI
is needed.
"""

from __future__ import annotations

import argparse
import logging

from svpc_torch.cli.common import (add_common_args, add_mesh_args,
                                   add_train_args, train_config_from_args)
from svpc_torch.train.loop import train


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-10s: %(message)s")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(p)
    add_mesh_args(p, train=True)
    add_train_args(p)
    p.add_argument("--workdir", required=True)
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--no_language_eval", action="store_true",
                   help="skip the greedy decode and language metrics of "
                        "each epoch; select checkpoint_best by validation "
                        "loss")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="trace this many steady-state steps with "
                        "torch.profiler")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly detection (the reference's "
                        "always-on check, off by default for speed)")
    p.add_argument("--resume_from", default=None,
                   help="checkpoint to resume from (params, optimizer, EMA, "
                        "step; a mid-epoch checkpoint resumes inside its "
                        "epoch exactly)")
    args = p.parse_args(argv)
    cfg = train_config_from_args(args)
    if args.debug:
        args.max_steps_per_epoch = 1
    return train(cfg, args.workdir,
                 max_steps_per_epoch=args.max_steps_per_epoch,
                 eval_language=not args.no_language_eval,
                 debug_nans=args.debug_nans, resume_from=args.resume_from,
                 device=args.device, tensorboard=not args.no_tensorboard,
                 profile_steps=args.profile_steps)


if __name__ == "__main__":
    from svpc_torch.parallel.mesh import close_distributed

    main()
    close_distributed()

"""Convert a feature store to float16 — half the disk, page-cache and
host memory traffic of the reference's float32 `.npy` files (the port of
svpc_tpu/cli/convert_features.py).

The native packer (svpc_torch/native) reads '<f2' files directly (exact
widening back to f32 in the fill — packer.cpp half_to_float), and the
numpy fill casts on load, so a converted store is a drop-in replacement:

    python -m svpc_torch.cli.convert_features \
        --input_dir /data/features --output_dir /data/features_f16

Training in bfloat16 is insensitive to the f32->f16 rounding (bf16 keeps
fewer mantissa bits than f16); keep the f32 store for bit-exact
reference-parity work.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def convert_tree(input_dir: str, output_dir: str,
                 dtype=np.float16) -> int:
    """Convert every .npy under input_dir (recursively, preserving the
    training/validation layout); returns the number of files written."""
    n = 0
    out_abs = os.path.abspath(output_dir)
    for root, dirs, files in os.walk(input_dir):
        # never descend into the output tree (an output_dir nested inside
        # input_dir would otherwise be re-converted recursively)
        dirs[:] = [d for d in dirs
                   if os.path.abspath(os.path.join(root, d)) != out_abs]
        rel = os.path.relpath(root, input_dir)
        dst_root = os.path.join(output_dir, rel) if rel != "." else output_dir
        for fn in sorted(files):
            if not fn.endswith(".npy"):
                continue
            os.makedirs(dst_root, exist_ok=True)
            arr = np.load(os.path.join(root, fn))
            np.save(os.path.join(dst_root, fn), arr.astype(dtype))
            n += 1
    return n


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)-10s: %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--dtype", default="float16", choices=["float16"])
    args = p.parse_args(argv)
    if os.path.abspath(args.input_dir) == os.path.abspath(args.output_dir):
        raise SystemExit("output_dir must differ from input_dir")
    n = convert_tree(args.input_dir, args.output_dir,
                     {"float16": np.float16}[args.dtype])
    if not n:
        raise SystemExit(f"no .npy files under {args.input_dir}")
    logger.info("converted %d files to %s", n, args.output_dir)


if __name__ == "__main__":
    main()

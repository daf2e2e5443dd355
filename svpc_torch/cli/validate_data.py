"""Validate a data directory before training/serving.

The reference silently drops every video whose feature files are missing
(fix_missing, recursive_caption_dataset.py:95-110) and crashes deep in
the pipeline on anything else (bad npy, absent duration row, span
assertions).  A production deployment wants the full damage report up
front:

    python -m svpc_torch.cli.validate_data --split train \
        --data_dir .../yc2_data --video_feature_dir features \
        --duration_file duration.csv \
        --word2idx_path cache/yc2_word2idx.json \
        --verb2idx_path cache/bosselut_verb_vocab.json

or, for a GT-free inference/serving spec:

    python -m svpc_torch.cli.validate_data --input_json videos.json ...

Checks per video (mirroring the pipeline's real math):
  errors   — missing/unreadable feature files, resnet/bn row mismatch,
             wrong feature dims, missing duration row, inverted or
             empty-span timestamps, training-split ingredient budget
             overflows (max_oov / max_entities / max_ingr_words)
  warnings — timestamps beyond the video duration (span clamps),
             sentences longer than the max_t_len budget (labels
             truncate), more clips than max_n_sen (extra clips drop),
             float64 feature files (converted on load)

Exit status: 1 if any video has errors (or, with --strict, warnings).

The port of svpc_tpu/cli/validate_data.py, on the port's FeatureStore,
npy_header and pipeline helpers.  svpc_tpu's CLI takes the model's
feature width from its architecture flags; the port's inference flags
carry none, so ``--video_feature_size`` (default 3072) gives it here.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os

import numpy as np

from svpc_torch import tokenization as tok
from svpc_torch.cli.common import add_common_args, config_from_args
from svpc_torch.data.anet import (load_annotations, load_durations,
                                  timestamp_to_feature_span,
                                  video_feature_name)
from svpc_torch.data.features import FeatureStore, npy_header
from svpc_torch.data.pipeline import (build_ingredient_arrays,
                                      inference_entries, resolve_feature_dir)

logger = logging.getLogger(__name__)


def validate_video(entry, store: FeatureStore, frame_to_second, vocab,
                   cfg, video_name: str, strict_budgets: bool):
    """-> (errors, warnings): every check the pipeline would later
    enforce by assertion/exception, as messages."""
    m = cfg.model
    errors, warnings = [], []

    p_resnet, p_bn = store.paths(video_name)
    rows = None
    if not (os.path.exists(p_resnet) and os.path.exists(p_bn)):
        errors.append(f"missing feature file(s): "
                      f"{[p for p in (p_resnet, p_bn) if not os.path.exists(p)]}")
    else:
        try:
            (r_rows, r_dim), r_dtype = npy_header(p_resnet)
            (b_rows, b_dim), b_dtype = npy_header(p_bn)
            if r_rows != b_rows:
                errors.append(f"resnet rows {r_rows} != bn rows {b_rows}")
            if min(r_rows, b_rows) == 0:
                # falsy rows would silently skip every span check below,
                # and the pipeline's span math negative-indexes an empty
                # array for such files
                errors.append("feature files have 0 rows")
            if r_dim + b_dim != m.video_feature_size:
                errors.append(
                    f"feature dims {r_dim}+{b_dim} != "
                    f"video_feature_size {m.video_feature_size}")
            for kind, dt in (("resnet", r_dtype), ("bn", b_dtype)):
                if dt.itemsize > 4:
                    warnings.append(f"{kind} dtype {dt} (converted to "
                                    "float32 on load; consider "
                                    "cli.convert_features)")
            rows = min(r_rows, b_rows)
        except Exception as e:
            errors.append(f"unreadable npy header: {e}")

    frm2sec = frame_to_second.get(video_name)
    if frm2sec is None:
        errors.append("no duration-CSV row")
    elif frm2sec <= 0:
        errors.append(f"nonpositive frm2sec {frm2sec}")

    n_sen = len(entry["timestamps"])
    if n_sen > m.max_n_sen:
        warnings.append(f"{n_sen} clips > max_n_sen={m.max_n_sen} "
                        f"(training keeps the first {m.max_n_sen})")
    for i, ts in enumerate(entry["timestamps"]):
        if len(ts) != 2:
            errors.append(f"clip {i}: timestamp {ts} is not [start, end]")
            continue
        try:
            s, e = float(ts[0]), float(ts[1])
        except (TypeError, ValueError):
            errors.append(f"clip {i}: non-numeric timestamp {ts}")
            continue
        if not (math.isfinite(s) and math.isfinite(e)) \
                or s < 0 or e < s:
            errors.append(f"clip {i}: bad timestamp [{s}, {e}]")
            continue
        if frm2sec and rows:
            st, ed = (int(np.floor(s / frm2sec)),
                      int(np.ceil(e / frm2sec)))
            if st >= rows:
                errors.append(
                    f"clip {i}: starts at feature row {st} but the video "
                    f"has only {rows} rows (timestamp beyond features)")
            elif ed > rows - 1:
                warnings.append(
                    f"clip {i}: ends at row {ed} > last feature row "
                    f"{rows - 1} (span clamps)")
            if min(ed, rows - 1) <= 0:
                errors.append(
                    f"clip {i}: empty feature span for [{s}, {e}]")
            else:
                # the exact pipeline math must hold (asserts otherwise)
                try:
                    timestamp_to_feature_span(rows, (s, e), frm2sec)
                except AssertionError as ex:
                    errors.append(f"clip {i}: span assertion — {ex}")

    for i, sent in enumerate(entry.get("sentences", [])[:m.max_n_sen]):
        n_toks = len(tok.word_tokenize(sent.lower()))
        if n_toks > m.max_t_len - 2:
            warnings.append(
                f"clip {i}: sentence has {n_toks} tokens > "
                f"max_t_len-2={m.max_t_len - 2} (labels truncate)")

    try:
        build_ingredient_arrays(
            entry.get("ingredients", []), vocab, m.max_i_len,
            m.max_entities, m.max_oov, m.max_ingr_words,
            strict=strict_budgets)
    except ValueError as e:
        errors.append(f"ingredient budgets: {e}")

    return errors, warnings


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--split", default="",
                   choices=["", "train", "val", "test"],
                   help="validate an annotated split")
    p.add_argument("--input_json", default="",
                   help="validate a GT-free inference/serving spec "
                        "({vid: {timestamps, ingredients}})")
    p.add_argument("--strict", action="store_true",
                   help="exit 1 on warnings too")
    p.add_argument("--video_feature_size", type=int, default=3072,
                   help="the model's resnet+bn feature width")
    args = p.parse_args(argv)
    if bool(args.split) == bool(args.input_json):
        p.error("pass exactly one of --split / --input_json")
    cfg = config_from_args(args).replace_model(
        video_feature_size=args.video_feature_size)
    d, m = cfg.data, cfg.model

    pre_errors = []  # (video, message) for spec lines that can't even parse
    if args.split:
        entries = load_annotations(d.data_dir, args.split, 10 ** 9)
        strict_budgets = True
    else:
        with open(args.input_json) as f:
            spec = json.load(f)
        if not isinstance(spec, dict):
            raise SystemExit(f"malformed spec {args.input_json}: expected "
                             "a JSON object {vid: {timestamps, ...}}")
        # per-video parse: one malformed line must not abort the whole
        # damage report (ingredients are optional, matching the daemon)
        entries = []
        for vid, line in spec.items():
            try:
                if not isinstance(line, dict):
                    raise ValueError("spec line is not an object")
                entries.append(inference_entries(
                    {vid: dict(line,
                               ingredients=list(line.get("ingredients",
                                                         [])))},
                    10 ** 9)[0])
            except (KeyError, ValueError, TypeError) as e:
                pre_errors.append((vid, f"malformed spec line: {e}"))
        strict_budgets = False
    store = FeatureStore(resolve_feature_dir(
        d.video_feature_dir, args.split or "val"))
    frame_to_second = load_durations(d.duration_file, d.dset_name,
                                     d.sampling_sec)
    vocab = tok.Vocabulary.from_json(d.word2idx_path)

    n_err = n_warn = 0
    for vid, msg in pre_errors:
        logger.info("ERROR   %s: %s", vid, msg)
        n_err += 1
    for entry in entries:
        vn = video_feature_name(entry["name"], d.dset_name)
        errors, warnings = validate_video(
            entry, store, frame_to_second, vocab, cfg, vn, strict_budgets)
        for msg in errors:
            logger.info("ERROR   %s: %s", entry["name"], msg)
        for msg in warnings:
            logger.info("WARNING %s: %s", entry["name"], msg)
        n_err += bool(errors)
        n_warn += bool(warnings)

    logger.info("%d video(s): %d with errors, %d with warnings",
                len(entries) + len(pre_errors), n_err, n_warn)
    if n_err or (args.strict and n_warn):
        raise SystemExit(1)


if __name__ == "__main__":
    main()

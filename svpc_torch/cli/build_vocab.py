"""Vocabulary + GloVe extraction CLI (reference: src/build_vocab.py +
scripts/build_vocab.sh): the port of svpc_tpu/cli/build_vocab.py.

Builds the min-count word vocabulary from training sentences and extracts
GloVe rows for the word and verb vocabularies (misses get randn*0.4,
reference build_vocab.py:68-82).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from svpc_torch.tokenization import build_vocab


def load_glove_txt(path: str):
    glove = {}
    with open(path) as f:
        for line in f:
            values = line.strip("\n").split(" ")
            glove[values[0]] = np.asarray([float(e) for e in values[1:]])
    return glove


def extract_glove(word2idx, glove, glove_dim=300, seed=None):
    rng = np.random if seed is None else np.random.RandomState(seed)
    idx2word = {v: k for k, v in word2idx.items()}
    matrix = np.zeros([len(word2idx), glove_dim], dtype=np.float64)
    for i in range(len(idx2word)):
        w = idx2word[i]
        matrix[i] = glove[w] if w in glove else rng.randn(glove_dim) * 0.4
    return matrix


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_path", required=True)
    p.add_argument("--dset_name", default="yc2")
    p.add_argument("--cache", default="./cache")
    # the reference script of record passes 3 (scripts/build_vocab.sh:9)
    p.add_argument("--min_word_count", type=int, default=3)
    p.add_argument("--raw_glove_path", default=None)
    p.add_argument("--verb_vocab_path", default=None)
    args = p.parse_args(argv)
    os.makedirs(args.cache, exist_ok=True)

    with open(args.train_path) as f:
        train_data = json.load(f)
    sentences = [s for v in train_data.values() for s in v["sentences"]]
    word2idx = build_vocab(sentences, args.min_word_count)
    out = os.path.join(args.cache, f"{args.dset_name}_word2idx.json")
    with open(out, "w") as f:
        f.write(json.dumps(word2idx, indent=4))
    print(f"vocab size {len(word2idx)} -> {out}")

    if args.raw_glove_path:
        glove = load_glove_txt(args.raw_glove_path)
        matrix = extract_glove(word2idx, glove)
        np.save(os.path.join(args.cache, f"{args.dset_name}_vocab_glove.npy"),
                matrix)
        if args.verb_vocab_path:
            with open(args.verb_vocab_path) as f:
                verb2idx = json.load(f)
            vmatrix = extract_glove(verb2idx, glove)
            np.save(os.path.join(
                args.cache,
                f"bosselut_{args.dset_name}_verb_vocab_glove.npy"), vmatrix)


if __name__ == "__main__":
    main()

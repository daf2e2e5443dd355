"""POS/verb vocabulary builder (reference: src/build_pos_vocab.py +
cache/pos_vocab_word2idx.json).

The reference runs spaCy offline with hard-coded author paths
(build_pos_vocab.py:51) to (a) build a VERB/NOUN vocabulary from training
sentences (ids from 0 in first-seen order, no specials — exactly the
shipped cache/pos_vocab_word2idx.json schema) and (b) attach per-step
``pos`` word lists into the anet-format annotation JSONs
(build_pos_vocab.py:32-46: ``val["pos"] = [[word, ...], ...]``, only
words present in the vocab).  This CLI does the same with a pluggable
tagger: spaCy when an en model is installed, otherwise the
self-contained lexicon+rule tagger (svpc_torch/tagging.py — data-free,
measured at 0.99 type recall / 0.79 precision against the shipped
spaCy-built vocab; the gap is spaCy's PROPN treatment of foreign food
words).  Unlike the
reference, annotated copies are written to --out_dir instead of
overwriting the input files.

The port of svpc_tpu/cli/build_pos_vocab.py, whose third backend, nltk's
perceptron tagger, svpc_torch does not have (it never imports nltk):
``--tagger nltk`` exits with a message, as svpc_tpu's CLI does for a
backend whose data is missing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, List, Optional, Tuple


Tagger = Callable[[str], List[Tuple[str, str]]]


def spacy_tagger() -> Optional[Tagger]:
    try:
        import spacy
        nlp = spacy.load("en_core_web_sm", disable=["parser", "ner"])
    except Exception:
        return None

    def tag(sentence: str):
        return [(t.text, t.pos_) for t in nlp(sentence)]
    return tag


def build_pos_vocab(annotations: dict, tag: Tagger) -> dict:
    """VERB/NOUN word2idx over all training sentences — ids from 0 in
    first-seen order, no special tokens (reference build_pos_vocab.py:
    16-30; matches the shipped cache/pos_vocab_word2idx.json exactly:
    1558 entries, min id 0, no [PAD]/[UNK])."""
    word2idx: dict = {}
    for vid, ann in annotations.items():
        for sentence in ann["sentences"]:
            for w, p in tag(sentence):
                if p in ("VERB", "NOUN") and w not in word2idx:
                    word2idx[w] = len(word2idx)
    return word2idx


def attach_pos(annotations: dict, word2idx: dict, tag: Tagger) -> dict:
    """Attach ``val["pos"] = [[word, ...] per step]`` keeping only
    VERB/NOUN words present in the vocab (reference
    build_pos_vocab.py:32-46).  Returns the (mutated) annotations."""
    for vid, ann in annotations.items():
        step_pos_words = []
        for sentence in ann["sentences"]:
            step_pos_words.append(
                [w for w, p in tag(sentence)
                 if p in ("VERB", "NOUN") and w in word2idx])
        ann["pos"] = step_pos_words
    return annotations


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--train_path", required=True,
                   help="anet-format training annotations (vocab source)")
    p.add_argument("--attach", nargs="*", default=[],
                   help="additional anet-format files to attach 'pos' "
                        "lists to (e.g. the val split)")
    p.add_argument("--cache", default="./cache")
    p.add_argument("--out_dir", default=None,
                   help="where pos-annotated copies go (default: --cache)")
    p.add_argument("--tagger", default="auto",
                   choices=["auto", "spacy", "nltk", "lexicon"],
                   help="POS backend; auto prefers spacy > the built-in "
                        "lexicon tagger (nltk is not a dependency of "
                        "svpc_torch: use svpc_tpu's CLI for it)")
    p.add_argument("--verb2idx_path", default=None,
                   help="verb-vocab JSON seeding the lexicon tagger "
                        "(e.g. cache/bosselut_verb_vocab.json); ignored "
                        "by the spacy backend")
    args = p.parse_args(argv)

    def lex():
        from svpc_torch.tagging import lexicon_tagger
        print("using the built-in lexicon tagger (approximate — see "
              "svpc_torch/tagging.py; spaCy model data unavailable)"
              if args.tagger == "auto" else
              "using the built-in lexicon tagger (approximate)",
              file=sys.stderr)
        return lexicon_tagger(args.verb2idx_path)

    if args.tagger == "auto":
        tagger = spacy_tagger() or lex()
    else:
        tagger = {"spacy": spacy_tagger, "nltk": lambda: None,
                  "lexicon": lex}[args.tagger]()
    if tagger is None:
        raise SystemExit(
            f"the requested --tagger {args.tagger} backend is not "
            "available (" + ("svpc_torch does not use nltk"
                             if args.tagger == "nltk" else
                             "model data missing") + ").  Use "
            "--tagger lexicon for the self-contained fallback, or the "
            "reference's published cache/pos_vocab_word2idx.json directly.")

    # tagging dominates wall-clock and every train sentence is tagged
    # twice (vocab build + pos attach): memoize per sentence
    _memo: dict = {}
    raw_tagger = tagger

    def tagger(sentence, _memo=_memo, _tag=raw_tagger):
        if sentence not in _memo:
            _memo[sentence] = _tag(sentence)
        return _memo[sentence]

    with open(args.train_path) as f:
        annotations = json.load(f)
    word2idx = build_pos_vocab(annotations, tagger)
    os.makedirs(args.cache, exist_ok=True)
    out = os.path.join(args.cache, "pos_vocab_word2idx.json")
    with open(out, "w") as f:
        json.dump(word2idx, f)
    print(f"pos vocab size {len(word2idx)} -> {out}")

    out_dir = args.out_dir or args.cache
    os.makedirs(out_dir, exist_ok=True)
    sources = [args.train_path] + list(args.attach)
    names = [os.path.basename(p) for p in sources]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise SystemExit(
            f"output collision in {out_dir}: {sorted(dupes)} — annotated "
            "copies are written under their input basenames, so inputs "
            "from different directories with the same filename would "
            "silently overwrite each other.  Rename the inputs or run "
            "with separate --out_dir invocations.")
    clobbered = [p for p in sources
                 if os.path.realpath(os.path.join(out_dir,
                                                  os.path.basename(p)))
                 == os.path.realpath(p)]
    if clobbered:
        raise SystemExit(
            f"annotated copies would overwrite the input file(s) "
            f"{clobbered} in place — pass an --out_dir different from "
            "the directory the inputs live in.")
    for path in sources:
        if path == args.train_path:
            anns = annotations  # already loaded (and its tags memoized)
        else:
            with open(path) as f:
                anns = json.load(f)
        attach_pos(anns, word2idx, tagger)
        dst = os.path.join(out_dir, os.path.basename(path))
        with open(dst, "w") as f:
            json.dump(anns, f)
        print(f"pos-annotated -> {dst}")


if __name__ == "__main__":
    main()

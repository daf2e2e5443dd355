"""svpc_torch's vocabulary tools against svpc_tpu's, on the CPU, on
synthetic annotations and a small GloVe text file written here:
``tokenization.build_vocab`` and ``cli.build_vocab`` (the word2idx and the
GloVe matrices), ``tagging.py`` and ``cli.build_pos_vocab`` (the POS
vocabulary and the annotated copies)."""

import json
import sys

import numpy as np
import pytest

WORDS = ("add chop the onions and stir into a hot pan with oil then fry "
         "garlic until golden slice peppers season salt pepper whisk eggs "
         "pour over mix gently serve warm apply glaze bake slowly "
         "cut in half jelly roll brown beef beaten peeled").split()
VERBS = ["add", "chop", "stir", "fry", "slice", "season", "whisk", "pour",
         "mix", "serve", "bake", "cut", "brown", "peel", "beat", "roll"]


def _annotations(seed, n_videos, prefix):
    rng = np.random.RandomState(seed)
    anns = {}
    for v in range(n_videos):
        sents = [" ".join(rng.choice(WORDS, rng.randint(3, 10))) + "."
                 for _ in range(rng.randint(2, 6))]
        anns[f"{prefix}{v}"] = {"sentences": sents, "timestamps": [
            [float(i), float(i + 1)] for i in range(len(sents))]}
    return anns


def _write(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f)
    return str(path)


def _run(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    main()


def test_build_vocab_and_glove_match_svpc_tpu(tmp_path, monkeypatch):
    """build_vocab at several min counts, and the CLI's word2idx and
    GloVe matrices (words found in the text file copied, misses drawn
    from numpy's global generator) byte for byte."""
    from svpc_torch.cli.build_vocab import extract_glove, load_glove_txt
    from svpc_torch.cli.build_vocab import main as port_main
    from svpc_torch.tokenization import build_vocab
    from svpc_tpu.cli.build_vocab import main as jax_main
    from svpc_tpu.tokenization import build_vocab as jax_build_vocab

    anns = _annotations(0, 30, "vid")
    sents = [s for a in anns.values() for s in a["sentences"]]
    for min_count in (0, 1, 3, 5):
        assert build_vocab(sents, min_count) == \
            jax_build_vocab(sents, min_count)
    rng = np.random.RandomState(1)
    glove = tmp_path / "glove.txt"
    glove.write_text("".join(
        w + " " + " ".join(f"{x:.5f}" for x in rng.randn(300)) + "\n"
        for w in WORDS[::2] + VERBS[:5]))
    assert sorted(load_glove_txt(str(glove))) == sorted(
        set(WORDS[::2] + VERBS[:5]))
    train = _write(tmp_path / "train.json", anns)
    verbs = _write(tmp_path / "verbs.json",
                   {v: i for i, v in enumerate(VERBS)})
    out = {}
    for name, main in (("port", port_main), ("tpu", jax_main)):
        cache = tmp_path / name
        np.random.seed(7)
        _run(main, ["--train_path", train, "--cache", str(cache),
                    "--min_word_count", "2", "--raw_glove_path", str(glove),
                    "--verb_vocab_path", verbs], monkeypatch)
        out[name] = [(cache / f).read_bytes() for f in (
            "yc2_word2idx.json", "yc2_vocab_glove.npy",
            "bosselut_yc2_verb_vocab_glove.npy")]
    assert out["port"] == out["tpu"]
    w2i = json.loads(out["port"][0])
    m = extract_glove(w2i, load_glove_txt(str(glove)), seed=0)
    assert m.shape == (len(w2i), 300)


def test_pos_tagger_and_build_pos_vocab_match_svpc_tpu(tmp_path,
                                                       monkeypatch):
    """The lexicon tagger (verb inflections, tags of every sentence) and
    cli.build_pos_vocab --tagger lexicon (the POS vocabulary and the
    annotated copies) equal svpc_tpu's; --tagger auto takes the lexicon
    tagger where spaCy is absent; --tagger nltk exits with a message."""
    from svpc_torch.cli.build_pos_vocab import main as port_main
    from svpc_torch.tagging import lexicon_tagger, verb_inflections
    from svpc_tpu.cli.build_pos_vocab import main as jax_main
    from svpc_tpu.tagging import lexicon_tagger as jax_tagger
    from svpc_tpu.tagging import verb_inflections as jax_inflections

    for lemma in VERBS + ["apply", "fry", "stop", "tie", "dry"]:
        assert verb_inflections(lemma) == jax_inflections(lemma)
    train, val = _annotations(2, 25, "tr"), _annotations(3, 10, "va")
    verbs = _write(tmp_path / "verbs.json",
                   {v: i for i, v in enumerate(VERBS)})
    port, jax = lexicon_tagger(verbs), jax_tagger(verbs)
    for a in list(train.values()) + list(val.values()):
        for s in a["sentences"]:
            assert port(s) == jax(s), s
    src = tmp_path / "src"
    src.mkdir()
    paths = [_write(src / "train.json", train), _write(src / "val.json", val)]
    outs = {}
    for name, main, tagger in (("port", port_main, "lexicon"),
                               ("tpu", jax_main, "lexicon"),
                               ("port_auto", port_main, "auto")):
        cache = tmp_path / name
        _run(main, ["--train_path", paths[0], "--attach", paths[1],
                    "--cache", str(cache), "--tagger", tagger,
                    "--verb2idx_path", verbs], monkeypatch)
        outs[name] = [(cache / f).read_bytes() for f in (
            "pos_vocab_word2idx.json", "train.json", "val.json")]
    assert outs["port"] == outs["tpu"] == outs["port_auto"]
    assert json.loads(outs["port"][0])
    with pytest.raises(SystemExit, match="does not use nltk"):
        _run(port_main, ["--train_path", paths[0], "--cache",
                         str(tmp_path / "n"), "--tagger", "nltk"],
             monkeypatch)

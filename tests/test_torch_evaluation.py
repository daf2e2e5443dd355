"""svpc_torch's caption scorers (svpc_torch/evaluation) against
svpc_tpu's, on seeded (references, hypothesis) sets over the fixture
vocabulary and on tests/fixtures/meteor_fixture.json: equal to 1e-12, since
they are the same float arithmetic; ``evaluate_submission`` on one
submission and reference file gives an equal dict, METEOR's backend label
included; and the port's Porter stemmer equals nltk's on every word
METEOR sees here.  svpc_tpu's METEOR stems with nltk, the port with its
own stemmer (svpc_torch/evaluation/porter.py)."""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "meteor_fixture.json")
CORPUS = os.path.join(ROOT, "svpc_torch", "evaluation", "data",
                      "function_words_corpus.txt")
# inflected cooking words, so that METEOR's stem stage has matches to make
STEMS = ["chop", "slice", "stir", "add", "mix", "pour", "bake", "fry",
         "boil", "season", "whisk", "grate", "roll", "knead", "simmer",
         "drain", "serve", "garnish", "happy", "flour", "generous"]
ENDINGS = ["", "s", "es", "ed", "ing", "ies", "ied", "ly", "ness", "er",
           "ation", "ful", "ally", "ize", "able"]


def _words(rng, n):
    """Fixture-vocabulary words (data/synthetic.py's word{i}), function
    words and inflections, drawn from ``rng``."""
    with open(CORPUS) as f:
        function = [w.strip() for w in f if w.strip()
                    and not w.startswith("#")]
    pool = ([f"word{i}" for i in range(7, 64)] + function
            + [s + e for s in STEMS for e in ENDINGS])
    return [pool[i] for i in rng.randint(len(pool), size=n)]


def _gts_res(seed: int, n: int = 40):
    rng = np.random.RandomState(seed)
    sent = lambda: " ".join(_words(rng, rng.randint(3, 16)))
    gts = {i: [sent() for _ in range(rng.randint(1, 3))] for i in range(n)}
    res = {i: [sent() if rng.rand() > 0.1 else ""] for i in range(n)}
    # a few hypotheses that share most of a reference, inflected
    for i in range(0, n, 5):
        res[i] = [" ".join(w + "s" if rng.rand() < 0.3 else w
                           for w in gts[i][0].split())]
    with open(FIXTURE) as f:
        fx = json.load(f)
    for k, v in fx.items():
        gts[f"fx{k}"], res[f"fx{k}"] = v["refs"], [v["hyp"]]
    return gts, res


def _close(a, b, path="") -> None:
    """Equal structures; floats within 1e-12 (relative and absolute)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, rel=1e-12, abs=1e-12), path
    else:
        assert a == b, path


def test_scorers_match_svpc_tpu():
    """BLEU 1-4, CIDEr-D, ROUGE-L and METEOR corpus and per-id scores;
    repetition, caption statistics, diversity, dense (tIoU) evaluation and
    ingredient F1, on seeded data."""
    import svpc_tpu.evaluation as je
    import svpc_torch.evaluation as pe
    from svpc_tpu.evaluation import (bleu as jb, cider as jc,
                                     dense_eval as jd, diversity as jv,
                                     ingredient_f1 as ji, meteor as jm,
                                     repetition as jr, rouge as jro)
    from svpc_torch.evaluation import (bleu as pb, cider as pc,
                                       dense_eval as pd, diversity as pv,
                                       ingredient_f1 as pi, meteor as pm,
                                       repetition as pr, rouge as pro)

    assert je.evaluate_submission is not pe.evaluate_submission
    for seed in (0, 1):
        gts, res = _gts_res(seed)
        _close(jb.compute_bleu(gts, res), pb.compute_bleu(gts, res), "bleu")
        _close(jc.compute_cider_d(gts, res), pc.compute_cider_d(gts, res),
               "cider")
        _close(jro.compute_rouge_l(gts, res), pro.compute_rouge_l(gts, res),
               "rouge")
        want = jm.compute_meteor(gts, res)
        _close(want, pm.compute_meteor(gts, res), "meteor")
        assert want[2].startswith("python-approximation")

        rng = np.random.RandomState(seed + 10)
        pred = {f"v{i}": [{"sentence": " ".join(_words(rng, rng.randint(
            0, 9))), "timestamp": [float(j), float(j) + 2.5]}
            for j in range(rng.randint(1, 6))] for i in range(12)}
        refs = {f"v{i}": {"timestamps": [[float(j) + rng.rand(),
                                          float(j) + 2.0]
                                         for j in range(rng.randint(1, 6))],
                          "sentences": [" ".join(_words(rng, 6))
                                        for _ in range(5)]}
                for i in range(12)}
        training = [" ".join(_words(rng, 6)) for _ in range(50)]
        _close(jr.evaluate_repetition(pred, refs),
               pr.evaluate_repetition(pred, refs), "repetition")
        _close(jv.diversity_stats(pred, training),
               pv.diversity_stats(pred, training), "diversity")
        _close(jd.evaluate_dense_captions(pred, refs),
               pd.evaluate_dense_captions(pred, refs), "dense")

        recipes = {f"v{i}": {"ingredients": [" ".join(_words(rng, 2))
                                             for _ in range(4)],
                             "sentences": [e["sentence"] for e in p]}
                   for i, p in enumerate(pred.values())}
        gt_recipes = {k: dict(v, sentences=[" ".join(_words(rng, 7))
                                            for _ in v["sentences"]])
                      for k, v in recipes.items()}
        vocab = {w for r in recipes.values() for i in r["ingredients"]
                 for w in i.split()[:1]}
        _close(ji.ingredient_f1(gt_recipes, recipes, vocab),
               pi.ingredient_f1(gt_recipes, recipes, vocab), "ingredient")


def test_evaluate_submission_and_function_words_match(tmp_path,
                                                      monkeypatch):
    """The whole metric bundle of one submission file against one
    paragraph reference file; the METEOR function-word list and its label
    under the default and under ``SVPC_METEOR_FUNCTION_WORDS``."""
    from svpc_tpu.evaluation import evaluate_submission as jax_eval
    from svpc_tpu.evaluation import meteor as jm
    from svpc_torch.evaluation import evaluate_submission
    from svpc_torch.evaluation import meteor as pm

    rng = np.random.RandomState(3)
    results, paras = {}, {}
    for i in range(15):
        n = rng.randint(1, 7)
        results[f"vid{i:03d}"] = [
            {"sentence": " ".join(_words(rng, rng.randint(2, 12))),
             "timestamp": [float(j), float(j + 1)], "gt_sentence": ""}
            for j in range(n)]
        paras[f"vid{i:03d}"] = " ".join(
            " ".join(_words(rng, rng.randint(3, 12))) + "."
            for _ in range(n))
    paras["vid999"] = "a video with no prediction."
    ref = str(tmp_path / "para.json")
    with open(ref, "w") as f:
        json.dump(paras, f)
    submission = {"version": "VERSION 1.0", "results": results}
    want = jax_eval(submission, [ref])
    _close(want, evaluate_submission(submission, [ref]), "bundle")
    assert want["METEOR_backend"] == \
        "python-approximation[function_words=blend]"

    assert pm._load_function_words() == jm._load_function_words()
    monkeypatch.setenv("SVPC_METEOR_FUNCTION_WORDS", CORPUS)
    assert pm._load_function_words() == jm._load_function_words()
    assert pm._load_function_words()[1] == "function_words_corpus.txt"


def test_porter_stemmer_matches_nltk():
    """Every word of the METEOR fixture and of function_words_corpus.txt,
    and 6,000 seeded inflections (random letters and cooking stems with
    every suffix the algorithm's steps name)."""
    pytest.importorskip("nltk")
    from nltk.stem.porter import PorterStemmer
    from svpc_torch.evaluation import porter

    with open(FIXTURE) as f:
        fx = json.load(f)
    words = {w for v in fx.values() for s in [v["hyp"]] + v["refs"]
             for w in s.lower().split()}
    with open(CORPUS) as f:
        words |= {w.strip() for w in f if w.strip()
                  and not w.startswith("#")}
    suffixes = ["s", "es", "sses", "ies", "ied", "ed", "eed", "ing", "y",
                "ational", "tional", "enci", "anci", "izer", "bli", "alli",
                "entli", "eli", "ousli", "ization", "ation", "ator",
                "alism", "iveness", "fulness", "ousness", "aliti", "iviti",
                "biliti", "fulli", "logi", "icate", "ative", "alize",
                "iciti", "ical", "ful", "ness", "al", "ance", "ence", "er",
                "ic", "able", "ible", "ant", "ement", "ment", "ent", "ion",
                "sion", "tion", "ou", "ism", "ate", "iti", "ous", "ive",
                "ize", "e", "ll"]
    rng = np.random.RandomState(0)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    for _ in range(3000):
        stem = "".join(rng.choice(letters, rng.randint(1, 8)))
        words.add(stem + suffixes[rng.randint(len(suffixes))])
        words.add(STEMS[rng.randint(len(STEMS))]
                  + suffixes[rng.randint(len(suffixes))])
    words |= {"sky", "skies", "dying", "news", "innings", "proceed", "yyyy",
              "ab", "a", "flies", "dies", "spied", "died", "hopping",
              "falling", "hissing", "fizzed", "failing", "filing", "feed",
              "agreed", "controll", "roll", "geology", "generalli"}
    nltk_stem = PorterStemmer().stem
    bad = {w: (porter.stem(w), nltk_stem(w)) for w in sorted(words)
           if porter.stem(w) != nltk_stem(w)}
    assert not bad, bad

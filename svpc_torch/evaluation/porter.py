"""The Porter stemmer, as nltk's ``PorterStemmer()`` runs it by default
(mode ``NLTK_EXTENSIONS``), for METEOR's stem stage (evaluation/meteor.py).

Source: nltk 3.x, ``nltk/stem/porter.py`` (Apache License 2.0), after
Martin Porter, "An algorithm for suffix stripping" (1980).  The port
carries its own copy because the card's machine has no nltk; the copy
keeps only the default mode: the irregular-forms table, the 'ies'/'ied'
rules for four-letter words, the two-letter *o condition, step 1c's
(*c and not c) Y -> I, ALLI before BLI with a second pass through step 2,
and the FULLI and LOGI rules.  ``tests/test_torch_evaluation.py`` holds
it equal to nltk's on every word it is given.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

_IRREGULAR = {
    "sky": ["sky", "skies"], "die": ["dying"], "lie": ["lying"],
    "tie": ["tying"], "news": ["news"], "inning": ["innings", "inning"],
    "outing": ["outings", "outing"], "canning": ["cannings", "canning"],
    "howe": ["howe"], "proceed": ["proceed"], "exceed": ["exceed"],
    "succeed": ["succeed"],
}
_POOL = {form: stem for stem, forms in _IRREGULAR.items() for form in forms}
_VOWELS = frozenset("aeiou")

Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def _is_consonant(word: str, i: int) -> bool:
    """A letter other than a vowel, and other than a 'y' that follows a
    consonant (a run of 'y's alternates)."""
    if word[i] in _VOWELS:
        return False
    if word[i] == "y":
        negate = False
        while i > 0 and word[i] == "y":
            negate = not negate
            i -= 1
        return (word[i] not in _VOWELS) != negate
    return True


def _measure(stem: str) -> int:
    """m in [C](VC){m}[V]: the number of vowel-consonant transitions."""
    cv = "".join("c" if _is_consonant(stem, i) else "v"
                 for i in range(len(stem)))
    return cv.count("vc")


def _positive_measure(stem: str) -> bool:
    return _measure(stem) > 0


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    """*o: consonant-vowel-consonant, the last not w, x or y; or a
    two-letter vowel-consonant word."""
    n = len(word)
    return (n >= 3 and _is_consonant(word, n - 3)
            and not _is_consonant(word, n - 2)
            and _is_consonant(word, n - 1)
            and word[-1] not in ("w", "x", "y")) or (
        n == 2 and not _is_consonant(word, 0) and _is_consonant(word, 1))


def _strip(word: str, suffix: str) -> str:
    return word[:-len(suffix)] if suffix else word


def _apply_rules(word: str, rules: List[Rule]) -> str:
    """The first rule whose suffix matches decides: it applies when its
    condition holds on the stem, else the word stays.  The suffix "*d"
    matches a double consonant (the stem drops both letters)."""
    for suffix, replacement, condition in rules:
        if suffix == "*d" and _ends_double_consonant(word):
            stem = word[:-2]
        elif word.endswith(suffix):
            stem = _strip(word, suffix)
        else:
            continue
        if condition is None or condition(stem):
            return stem + replacement
        return word
    return word


def _step1a(word: str) -> str:
    if word.endswith("ies") and len(word) == 4:
        return _strip(word, "ies") + "ie"
    return _apply_rules(word, [("sses", "ss", None), ("ies", "i", None),
                               ("ss", "ss", None), ("s", "", None)])


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        return _strip(word, "ied") + ("ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        stem = _strip(word, "eed")
        return stem + "ee" if _measure(stem) > 0 else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix) and _contains_vowel(_strip(word, suffix)):
            stem = _strip(word, suffix)
            break
    else:
        return word
    return _apply_rules(stem, [
        ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
        ("*d", stem[-1], lambda _: stem[-1] not in ("l", "s", "z")),
        ("", "e", lambda s: _measure(s) == 1 and _ends_cvc(s))])


def _step1c(word: str) -> str:
    return _apply_rules(word, [
        ("y", "i", lambda s: len(s) > 1 and _is_consonant(s, len(s) - 1))])


_STEP2 = [(suffix, repl, _positive_measure) for suffix, repl in (
    ("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
    ("anci", "ance"), ("izer", "ize"), ("bli", "ble"), ("alli", "al"),
    ("entli", "ent"), ("eli", "e"), ("ousli", "ous"), ("ization", "ize"),
    ("ation", "ate"), ("ator", "ate"), ("alism", "al"), ("iveness", "ive"),
    ("fulness", "ful"), ("ousness", "ous"), ("aliti", "al"),
    ("iviti", "ive"), ("biliti", "ble"), ("fulli", "ful"))]


def _step2(word: str) -> str:
    if word.endswith("alli") and _positive_measure(_strip(word, "alli")):
        return _step2(_strip(word, "alli") + "al")
    # the 'l' of LOGI stays with the stem ('geo', 'theo' work like 'philo')
    return _apply_rules(word, _STEP2 + [
        ("logi", "log", lambda _: _positive_measure(word[:-3]))])


_STEP3 = [(suffix, repl, _positive_measure) for suffix, repl in (
    ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
    ("ical", "ic"), ("ful", ""), ("ness", ""))]


def _step3(word: str) -> str:
    return _apply_rules(word, _STEP3)


def _measure_gt_1(stem: str) -> bool:
    return _measure(stem) > 1


_STEP4 = [(suffix, "", _measure_gt_1) for suffix in (
    "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
    "ment", "ent")] + [
    ("ion", "", lambda s: _measure(s) > 1 and s[-1] in ("s", "t"))] + [
    (suffix, "", _measure_gt_1) for suffix in (
        "ou", "ism", "ate", "iti", "ous", "ive", "ize")]


def _step4(word: str) -> str:
    return _apply_rules(word, _STEP4)


def _step5a(word: str) -> str:
    # both E rules are tried (unlike _apply_rules' first match)
    if word.endswith("e"):
        stem = word[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _ends_cvc(stem)):
            return stem
    return word


def _step5b(word: str) -> str:
    return _apply_rules(word, [("ll", "l",
                                lambda _: _measure(word[:-1]) > 1)])


def stem(word: str) -> str:
    """The lower-cased stem of ``word``, as ``nltk.stem.porter.
    PorterStemmer().stem(word)`` gives it."""
    w = word.lower()
    if w in _POOL:
        return _POOL[w]
    if len(word) <= 2:
        return w
    for step in (_step1a, _step1b, _step1c, _step2, _step3, _step4,
                 _step5a, _step5b):
        w = step(w)
    return w

"""Self-contained VERB/NOUN tagger for recipe-style English: the port's
copy of svpc_tpu/tagging.py (the same lexicon, rules and numbers below,
which were measured on svpc_tpu's copy; tests/test_torch_vocab.py holds
the two taggers equal).

The reference builds its POS vocabulary with spaCy (`src/build_pos_vocab.py:
24-29`), whose `en_core_web_sm` model data cannot be downloaded on an
air-gapped host.  This module is the data-free fallback: a lexicon +
context-rule tagger specialised to the imperative cooking-caption domain,
built entirely from artifacts already in the repo (the Bosselut verb
vocabulary the reference ships in `cache/bosselut_verb_vocab.json` and a
curated closed-class inventory below — a linguistic class list, distinct
from the METEOR fallback's corpus-frequency-derived function words).

It is an **approximation**, and a measured one: rebuilding the POS
vocabulary over the in-repo YC2 training annotations and comparing with
the reference's shipped spaCy-built `cache/pos_vocab_word2idx.json`
(1558 entries) gives type-level recall 0.9955 / precision 0.834
(`tests/test_pos_vocab.py::test_lexicon_tagger_agreement_with_shipped_vocab`;
0.790 before the round-3 adjective-class expansion, which removed 94
false positives with zero new misses).  The residual gap is measured to
be data-bound, not rule-bound: the remaining ~300 false positives are
(a) foreign-origin food words spaCy's trained model tags PROPN/X
("chili" ×185, "garam", "udon", "adobo") and (b) hapax misspellings
("avacodo", "corinader") — a char-trigram English-likelihood model
trained on every in-repo English source separates them from legitimate
hapax nouns ("asparagus", "blowtorch") at ~1 lost true word per removed
false one at every threshold (measured 2026-08-20), so no data-free
filter can push precision toward 0.9 without breaking the >=0.99 recall
bar.  The corpus is fully lowercase, so spaCy's case-based PROPN signal
does not exist here either.  A rebuilt vocab therefore comes out ~19%
larger than the artifact of record, never smaller.

Tag inventory is deliberately tiny: VERB / NOUN / OTHER — the only
distinction `build_pos_vocab` consumes (reference keeps tokens whose tag
is VERB or NOUN; everything else is discarded).
"""

from __future__ import annotations

import json
import re
from typing import List, Optional, Sequence, Tuple

# Closed-class inventory: articles, prepositions, conjunctions,
# pronouns, auxiliaries, common adverbial particles, punctuation.  This
# is a LINGUISTIC class list, deliberately NOT the METEOR fallback's
# corpus-frequency-derived function-word list (evaluation/meteor.py):
# METEOR 1.5's frequency rule on a cooking corpus also captures frequent
# domain verbs/nouns ("add", "bowl"), which would wrongly suppress the
# imperative-verb rule below (the two shared one constant until round 4).
_CLOSED_CLASS = frozenset("""
a an the this that these those some any each every no all both either
neither and or but nor so yet for if then than as because while when
where after before until unless although though since whether once
of in on at by with from to into onto over under above below between
among through during against about around off out up down near
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves themselves who whom whose which what
is are was were be been being am do does did done doing have has had
having will would shall should can could may might must ought
not n't no nor never also just only very too quite rather there here
now then again further once
. , ; : ! ? ' " ` `` '' - -- ( ) [ ] { }
""".split())

# Closed-class words the inventory above does not carry but that never
# contribute VERB/NOUN occurrences in this domain: adverbial particles and
# directionals spaCy tags ADV/ADP/PART.
_ADVERBIAL = frozenset("""
together aside once twice apart away almost along across behind
altogether anymore meanwhile
""".split())

# Content words the blanket "-ly => adverb" heuristic would swallow:
# recipe nouns (jelly roll, pork belly) — verbs like "apply" are instead
# recovered by checking the verb lexicon before the suffix rule.
_LY_NOUNS = frozenset("belly jelly lily assembly doily".split())

# Spelled-out numerals (spaCy: NUM, never VERB/NOUN).  "one" and "half"
# stay taggable — spaCy reads them as pronominal/partitive NOUNs ("add
# one", "cut in half") and the shipped vocab contains both.
_NUMBER_WORDS = frozenset("""
two three four five six seven eight nine ten eleven twelve dozen
twenty thirty forty fifty hundred thousand
""".split())

# Common recipe adjectives.  Context can still promote these to VERB
# (imperative "brown the beef") or NOUN; the list only suppresses the
# default-NOUN fallback in attributive position ("a large pan").
# Curated in semantic classes (colors, textures, shapes/sizes, quality,
# participial adjectives, nationalities/cuisines, ordinal/temporal) and
# measured against the shipped spaCy artifact: the round-3 expansion
# lifted type precision 0.790 -> 0.834 at unchanged 0.9955 recall with
# ZERO new misses (tests/test_pos_vocab.py).  Borderline words the
# shipped vocab KEEPS (spaCy saw nominal/verbal uses: "wet the paper",
# "the tender", "beaten"/"peeled" as verb participles) are deliberately
# absent: crispy, tender, wet, desired, beaten, peeled.
_ADJECTIVES = frozenset("""
hot cold warm small little big large thin thick fresh deep high low soft
hard fine coarse medium raw ready nice good bad better best same different
few many much more most less least long short round flat even gentle sweet
sour salty bitter other another several double triple single extra regular
plain favorite optional necessary entire boneless skinless lean tiny huge
black red golden pink blue dark light pale bright clear
crisp sticky stiff chunky creamy fluffy fatty tough damp moist dry
broad wide narrow tall straight diagonal circular spiral square outer
inner lower upper elastic firm smooth rough shiny translucent
empty full direct generous proper sharp quick slow heavy
complete special favourite homemade organic kosher excess
excessive uncooked unsalted unpeeled textured sized slotted non-stick
all-purpose bite-size bite-sized ball-shaped pre-heated preheated
candied dusted moistened strained whisked colored coloured
italian french chinese indian mexican japanese asian american korean
thai greek swiss canadian irish jamaican sicilian szechuan caribbean
cajun celtic himalayan turkish spanish german english russian
vietnamese filipino persian lebanese moroccan hawaiian
next second third new old overnight equal per till without instead
later earlier non wise active poor
""".split())

# Irregular past/participle forms -> their lemma (only verbs plausible in
# cooking captions; regular inflection is generated from the lemma).
_IRREGULAR = {
    "made": "make", "took": "take", "taken": "take", "given": "give",
    "gave": "give", "left": "leave", "kept": "keep", "laid": "lay",
    "broken": "break", "broke": "break", "brought": "bring",
    "thrown": "throw", "threw": "throw", "ground": "grind",
    "torn": "tear", "tore": "tear", "stuck": "stick", "frozen": "freeze",
    "froze": "freeze", "beaten": "beat", "done": "do",
}

_NUMBERISH = re.compile(r"(?:[\d/.,:%-]+|\d+\w*)\Z")
_HAS_LETTER = re.compile(r"[a-z]")
_CVC_TAIL = re.compile(r"[^aeiou][aeiou][^aeiouwxy]\Z")


def verb_inflections(lemma: str) -> set:
    """All regular surface forms of a verb lemma (3sg, gerund, past),
    with e-drop, final-consonant doubling and y->ies handling."""
    out = {lemma, lemma + "s", lemma + "es"}
    if lemma.endswith("e"):
        out |= {lemma[:-1] + "ing", lemma + "d"}
    else:
        out |= {lemma + "ing", lemma + "ed"}
        if _CVC_TAIL.search(lemma):  # chop -> chopping/chopped
            out |= {lemma + lemma[-1] + "ing", lemma + lemma[-1] + "ed"}
    if lemma.endswith("y") and len(lemma) > 2 and lemma[-2] not in "aeiou":
        out |= {lemma[:-1] + "ies", lemma[:-1] + "ied"}
    return out


class LexiconTagger:
    """Callable tagger: sentence -> [(token, tag)] with tags in
    {VERB, NOUN, OTHER}.  Same protocol as the spaCy/nltk tagger
    adapters in cli/build_pos_vocab.py."""

    def __init__(self, verb_lemmas: Optional[Sequence[str]] = None):
        lemmas = set(verb_lemmas or ())
        # common cooking verbs that END IN -ly (absent from the Bosselut
        # verb vocab) — without them the adverb suffix rule would swallow
        # "apply the glaze" even though it checks the lexicon first
        lemmas |= {"apply", "multiply"}
        forms = set()
        for v in lemmas:
            forms |= verb_inflections(v)
        forms |= set(_IRREGULAR)
        self.verb_lemmas = lemmas
        self.verb_forms = forms

    def tag_words(self, words: Sequence[str]) -> List[str]:
        tags: List[str] = []
        seen_content = False  # before the first content word = imperative slot
        for i, w in enumerate(words):
            lw = w.lower()
            prev = words[i - 1].lower() if i else None
            if (lw in _CLOSED_CLASS or lw in _ADVERBIAL
                    or lw in _NUMBER_WORDS
                    or _NUMBERISH.match(w) or not _HAS_LETTER.search(lw)):
                tags.append("OTHER")
                continue
            if (lw.endswith("ly") and len(lw) > 4  # adverbs; keeps "fly"
                    and lw not in self.verb_forms  # "apply", "multiply"
                    and lw not in _LY_NOUNS):      # "jelly", "belly"
                tags.append("OTHER")
                continue
            if not seen_content:
                # captions are imperative: the first content word is the
                # command verb ("brown the beef", "add the onions")
                if lw in self.verb_forms:
                    tags.append("VERB")
                else:
                    tags.append("OTHER" if lw in _ADJECTIVES else "NOUN")
                seen_content = True
                continue
            if lw in self.verb_forms and prev in ("to", "and", ","):
                # coordinated or infinitive verb ("... and stir", "to boil")
                tags.append("VERB")
                continue
            if lw in _ADJECTIVES:
                tags.append("OTHER")
                continue
            if (lw in self.verb_forms
                    and (lw.endswith("ing") or lw.endswith("ed"))
                    and (prev is None or prev not in _CLOSED_CLASS)):
                # participial use not governed by a determiner/preposition
                tags.append("VERB")
                continue
            tags.append("NOUN")
        return tags

    def __call__(self, sentence: str) -> List[Tuple[str, str]]:
        from svpc_torch.tokenization import word_tokenize
        words = word_tokenize(sentence)
        return list(zip(words, self.tag_words(words)))


def lexicon_tagger(verb_vocab_path: Optional[str] = None) -> LexiconTagger:
    """Build a LexiconTagger, optionally seeding the verb lexicon from a
    verb-vocab JSON (e.g. the reference's cache/bosselut_verb_vocab.json:
    384 cooking-verb lemmas)."""
    lemmas: Sequence[str] = ()
    if verb_vocab_path:
        with open(verb_vocab_path) as f:
            lemmas = list(json.load(f))
    return LexiconTagger(lemmas)

"""Tokenization and vocabulary.

The reference tokenizes with ``nltk.tokenize.word_tokenize`` (reference:
src/rtransformer/recursive_caption_dataset.py:443,463).  ``word_tokenize``
is punkt sentence-splitting followed by the Treebank word tokenizer; the
YC2 corpus contains no sentence-internal punctuation, so the Treebank
tokenizer applied to the whole string is exactly equivalent.

nltk is not a dependency of the port: the Treebank regex rules (NLTK
3.x ``TreebankWordTokenizer.tokenize`` with ``convert_parentheses=False``,
Robert MacIntyre's contraction lists included) are reproduced below, and
tests/test_torch_tokenization.py holds them against nltk.

Special tokens and ids follow recursive_caption_dataset.py:20-34.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

PAD_TOKEN = "[PAD]"
CLS_TOKEN = "[CLS]"
SEP_TOKEN = "[SEP]"
VID_TOKEN = "[VID]"
BOS_TOKEN = "[BOS]"
EOS_TOKEN = "[EOS]"
UNK_TOKEN = "[UNK]"

PAD = 0
CLS = 1
SEP = 2
VID = 3
BOS = 4
EOS = 5
UNK = 6
IGNORE = -1  # label value excluded from the caption loss

SPECIAL_TOKENS = {
    PAD_TOKEN: PAD, CLS_TOKEN: CLS, SEP_TOKEN: SEP, VID_TOKEN: VID,
    BOS_TOKEN: BOS, EOS_TOKEN: EOS, UNK_TOKEN: UNK,
}

# (pattern, replacement) passes in the order the Treebank tokenizer runs
_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")
_DOUBLE_DASHES = (re.compile(r"--"), r" -- ")
_ENDING_QUOTES = [
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
_CONTRACTIONS = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
    r"(?i) ('t)(?#X)(is)\b",
    r"(?i) ('t)(?#X)(was)\b",
)]


def word_tokenize(text: str) -> List[str]:
    """NLTK-word_tokenize-compatible tokenization for YC2-style text."""
    for regexp, sub in _STARTING_QUOTES + _PUNCTUATION + [
            _PARENS_BRACKETS, _DOUBLE_DASHES]:
        text = regexp.sub(sub, text)
    text = " " + text + " "
    for regexp, sub in _ENDING_QUOTES:
        text = regexp.sub(sub, text)
    for regexp in _CONTRACTIONS:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()


class Vocabulary:
    """word <-> id mapping with the reference's special-token layout."""

    def __init__(self, word2idx: Dict[str, int]):
        self.word2idx = word2idx
        self.idx2word = {int(v): k for k, v in word2idx.items()}
        for tok, idx in SPECIAL_TOKENS.items():
            if word2idx.get(tok) != idx:
                raise ValueError(f"vocabulary missing special token {tok}={idx}")

    def __len__(self) -> int:
        return len(self.word2idx)

    @classmethod
    def from_json(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            return cls(json.load(f))

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps(self.word2idx, indent=4))

    def get(self, token: str) -> int:
        return self.word2idx.get(token, UNK)

    def encode(self, tokens: Sequence[str]) -> List[int]:
        return [self.get(t) for t in tokens]

    def convert_ids_to_sentence(
        self,
        ids: Sequence[int],
        oov_word_dict: Optional[Dict[str, int]] = None,
        rm_padding: bool = True,
        return_sentence_only: bool = True,
    ) -> str:
        """ids -> text, resolving copy-produced OOV ids through
        ``oov_word_dict`` (reference: recursive_caption_dataset.py:472-500)."""
        oov_word_dict = oov_word_dict or {}
        oov_idx2word = {v: k for k, v in oov_word_dict.items()}
        rm_padding = True if return_sentence_only else rm_padding
        if rm_padding:
            raw_words = []
            for wid in ids:
                if wid in self.idx2word:
                    if wid not in (PAD, IGNORE):
                        raw_words.append(self.idx2word[wid])
                else:
                    raw_words.append(oov_idx2word[wid])
        else:
            raw_words = [self.idx2word[wid] for wid in ids if wid != IGNORE]

        if return_sentence_only:
            words = []
            for w in raw_words[1:]:  # skip [BOS]
                if w == EOS_TOKEN:
                    break
                words.append(w)
        else:
            words = raw_words
        return " ".join(words)


def build_vocab(
    sentences: Sequence[str], min_word_count: int = 5
) -> Dict[str, int]:
    """Build a word2idx from training sentences.

    Matches the reference builder (src/build_vocab.py:12-43): words kept
    iff ``count > min_word_count`` (strictly greater).  One deliberate
    deviation: the reference iterates a *set* of words when assigning
    ids, so its output permutes across runs (hash-randomized set order)
    — here ids follow first-appearance order in the corpus, so two runs
    on the same sentences produce the same word2idx (a vocab cache /
    checkpoint pair stays self-consistent when rebuilt).
    """
    tokenized = [word_tokenize(s.lower()) for s in sentences]
    word2idx = dict(SPECIAL_TOKENS)
    word_count: Dict[str, int] = {}
    for sent in tokenized:
        for w in sent:
            word_count[w] = word_count.get(w, 0) + 1
    for word, count in word_count.items():
        if word not in word2idx and count > min_word_count:
            word2idx[word] = len(word2idx)
    return word2idx


def tokenize_ingredients(
    ingredients: Sequence[str], max_i_len: int
) -> Tuple[List[str], List[int], List[int]]:
    """Tokenize an ingredient list into a flat ``w w [SEP] w [SEP] ...``
    stream (reference: recursive_caption_dataset.py:441-456).

    Returns (tokens padded to max_i_len, mask, sep_mask).
    """
    toks: List[str] = []
    for ingredient in ingredients:
        toks.extend(word_tokenize(ingredient.lower()))
        toks.append(SEP_TOKEN)
    valid_l = len(toks)
    mask = [1] * valid_l + [0] * (max_i_len - valid_l)
    toks = toks + [PAD_TOKEN] * (max_i_len - valid_l)
    toks = toks[:max_i_len]
    mask = mask[:max_i_len]
    sep_mask = [1 if t == SEP_TOKEN else 0 for t in toks]
    return toks, mask, sep_mask


def tokenize_sentence(sentence: str, max_t_len: int) -> Tuple[List[str], List[int]]:
    """``[BOS] w1 ... wN [EOS] [PAD]...`` of length max_t_len
    (reference: recursive_caption_dataset.py:458-470)."""
    toks = word_tokenize(sentence.lower())[: max_t_len - 2]
    toks = [BOS_TOKEN] + toks + [EOS_TOKEN]
    valid_l = len(toks)
    mask = [1] * valid_l + [0] * (max_t_len - valid_l)
    toks = toks + [PAD_TOKEN] * (max_t_len - valid_l)
    return toks, mask

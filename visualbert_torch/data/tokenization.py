"""WordPiece tokenizer (BERT-uncased scheme), the part of
``visualbert_tpu/data/tokenization.py`` the port uses, copied (importing the
JAX package pulls in JAX, which the port's machine does not have).

Host-side, pure Python: tokenization happens in the input pipeline, never on
device. Behavior-compatible with the reference's vendored tokenizer
(``visualbert/pytorch_pretrained_bert/tokenization.py:75-355``): basic
cleaning, lower-casing + accent stripping, punctuation/CJK splitting,
then greedy longest-match-first wordpiece with ``##`` continuations and a
max-chars-per-word cutoff to ``[UNK]``.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List


def load_vocab(path: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(path, "r", encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII non-alphanumeric ranges count as punctuation even when unicode
    # says otherwise ($, ~, etc.)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with lower-casing and accent
    stripping (bert-base-uncased)."""

    never_split = frozenset({"[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]"})

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        out: List[str] = []
        for tok in text.split():
            if tok in self.never_split:
                out.append(tok)
                continue
            out.extend(self._split_punct(self._strip_accents(tok.lower())))
        return " ".join(out).split()

    @staticmethod
    def _clean(text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            chars.append(" " if _is_whitespace(ch) else ch)
        return "".join(chars)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        chars = []
        for ch in text:
            if _is_cjk(ord(ch)):
                chars.append(f" {ch} ")
            else:
                chars.append(ch)
        return "".join(chars)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        pieces: List[str] = []
        current: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces


class WordpieceTokenizer:
    """Greedy longest-match-first subword splitting; a word longer than 100
    characters, or with no split into vocabulary pieces, is [UNK]."""

    unk_token = "[UNK]"
    max_chars_per_word = 100

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab

    def tokenize(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_token]
        pieces: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            piece = None
            while start < end:
                cand = word[start:end]
                if start > 0:
                    cand = "##" + cand
                if cand in self.vocab:
                    piece = cand
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            pieces.append(piece)
            start = end
        return pieces


class BertTokenizer:
    """Basic + WordPiece (reference tokenization.py:75-162)."""

    def __init__(self, vocab: Dict[str, int]):
        self.vocab = vocab
        self.ids_to_tokens = {i: t for t, i in vocab.items()}
        self.basic = BasicTokenizer()
        self.wordpiece = WordpieceTokenizer(vocab)

    @classmethod
    def from_file(cls, vocab_path: str) -> "BertTokenizer":
        return cls(load_vocab(vocab_path))

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece.tokenize(word))
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.vocab[t] for t in tokens]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.ids_to_tokens[i] for i in ids]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    # the special ids
    @property
    def cls_id(self) -> int:
        return self.vocab["[CLS]"]

    @property
    def sep_id(self) -> int:
        return self.vocab["[SEP]"]

    @property
    def mask_id(self) -> int:
        return self.vocab["[MASK]"]

    @property
    def pad_id(self) -> int:
        return self.vocab.get("[PAD]", 0)

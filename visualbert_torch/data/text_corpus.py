"""Packed text-only corpus (counterpart of ``visualbert_tpu/data/text_corpus.py``;
reference ``unsupervised_visualbert/src/pretrain/text_data.py``).

The corpus is tokenized once into one int32 token array with sentence and
passage offsets (text_data.py:58-122), saved as an ``.npz`` and memory-mapped
back. ``TextOnlyDataset`` draws MLM examples from it with whole-word masking
(text_data.py:415-451) and, optionally, the passage-pair matched objective
(text_data.py:249-297). Examples are byte-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from visualbert_torch.data.masking import MASK_PROB, MLM_IGNORE, assemble_pair, encode_single, random_word_wwm_pieces
from visualbert_torch.data.tokenization import BertTokenizer


class PackedCorpus:
    """``tokens``: one int32 array; ``sentence_offsets``: [n_sent + 1] into
    tokens; ``passage_offsets``: [n_passage + 1] into sentences."""

    def __init__(self, tokens: np.ndarray, sentence_offsets: np.ndarray, passage_offsets: np.ndarray):
        self.tokens = tokens
        self.sentence_offsets = sentence_offsets
        self.passage_offsets = passage_offsets

    @classmethod
    def build(cls, passages: Sequence[Sequence[str]], tokenizer: BertTokenizer) -> "PackedCorpus":
        """``passages``: a list of passages, each a list of sentence strings."""
        tok_list: List[int] = []
        sent_off = [0]
        pass_off = [0]
        for passage in passages:
            for sent in passage:
                tok_list.extend(tokenizer.encode(sent))
                sent_off.append(len(tok_list))
            pass_off.append(len(sent_off) - 1)
        return cls(np.asarray(tok_list, np.int32), np.asarray(sent_off, np.int64), np.asarray(pass_off, np.int64))

    def save(self, path: str):
        np.savez(path, tokens=self.tokens, sentence_offsets=self.sentence_offsets,
                 passage_offsets=self.passage_offsets)

    @classmethod
    def load(cls, path: str, mmap: bool = True) -> "PackedCorpus":
        data = np.load(path, mmap_mode="r" if mmap else None)
        return cls(data["tokens"], data["sentence_offsets"], data["passage_offsets"])

    @property
    def n_sentences(self) -> int:
        return len(self.sentence_offsets) - 1

    @property
    def n_passages(self) -> int:
        return len(self.passage_offsets) - 1

    def sentence(self, i: int) -> np.ndarray:
        return np.asarray(self.tokens[self.sentence_offsets[i]: self.sentence_offsets[i + 1]])

    def piece(self, passage: int, start_sent: int, max_tokens: int) -> np.ndarray:
        """Sequential sentences of a passage up to ``max_tokens``
        (text_data.py:132-172 retrieve_a_piece)."""
        return self.piece_with_span(passage, start_sent, max_tokens)[0]

    def piece_with_span(self, passage: int, start_sent: int, max_tokens: int,
                        stop_sent: Optional[int] = None) -> Tuple[np.ndarray, int]:
        """:meth:`piece` and the number of sentences it consumed, so a
        matched continuation starts after them. ``stop_sent`` (relative,
        exclusive) bounds the walk, so a wrapped continuation never re-enters
        an earlier span."""
        lo = int(self.passage_offsets[passage])
        hi = int(self.passage_offsets[passage + 1])
        out: List[np.ndarray] = []
        total = 0
        s0 = lo + (start_sent % max(hi - lo, 1))
        stop = hi if stop_sent is None else min(hi, lo + stop_sent)
        s = s0
        while s < stop and total < max_tokens:
            sent = self.sentence(s)
            out.append(sent)
            total += len(sent)
            s += 1
        if not out:
            return np.zeros(0, np.int32), 0
        return np.concatenate(out)[:max_tokens], s - s0

    def passage_n_sentences(self, passage: int) -> int:
        return int(self.passage_offsets[passage + 1]) - int(self.passage_offsets[passage])


class TextOnlyDataset:
    """MLM examples drawn from a :class:`PackedCorpus`, in the V&L dataset's
    text fields (no visual streams).

    ``matched_objective``: the example is ``[CLS] a [SEP] b [SEP]``, ``b`` a
    continuation of ``a``'s passage (``matched_label`` 1) or, half the time,
    a piece of another passage (0). ``group_continuations``: True is true
    whole-word masking over the packed wordpieces, False the reference's
    per-piece masking (``random_word_wwm_pieces``)."""

    def __init__(self, corpus: PackedCorpus, tokenizer: BertTokenizer, *, max_seq_length: int = 64,
                 mask_prob: float = MASK_PROB, matched_objective: bool = False, group_continuations: bool = True):
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.mask_prob = mask_prob
        self.matched_objective = matched_objective
        self.group_continuations = group_continuations
        self.ids_to_tokens = tokenizer.ids_to_tokens

    def __len__(self):
        return self.corpus.n_passages

    def _masked_piece(self, passage: int, start: int, budget: int, rng, stop_sent=None):
        piece, n_sents = self.corpus.piece_with_span(passage, start, budget, stop_sent=stop_sent)
        pieces = [self.ids_to_tokens[int(t)] for t in piece]
        tokens, labels = random_word_wwm_pieces(pieces, self.tokenizer, rng, self.mask_prob,
                                                group_continuations=self.group_continuations)
        return tokens[:budget], labels[:budget], n_sents

    def _other_passage(self, i: int, rng) -> int:
        j = int(rng.integers(self.corpus.n_passages))
        while j == i:
            j = int(rng.integers(self.corpus.n_passages))
        return j

    def __getitem__(self, args) -> Dict[str, np.ndarray]:
        i, rng = args
        T = self.max_seq_length
        if self.matched_objective:
            return self._matched_example(i, rng, T)

        tokens, labels, _ = self._masked_piece(i, int(rng.integers(1 << 30)), T - 2, rng)
        ids, mask, n = encode_single(self.tokenizer, tokens, T)
        lm = np.full(T, MLM_IGNORE, np.int32)
        lm[1: n - 1] = labels
        return {"input_ids": ids, "token_type_ids": np.zeros(T, np.int32), "input_mask": mask,
                "masked_lm_labels": lm}

    def _matched_example(self, i: int, rng, T: int) -> Dict[str, np.ndarray]:
        # two half-length parts (reference text_data.py:252 seq_len // 2)
        half = (T - 3) // 2
        start_a = int(rng.integers(1 << 30))
        tokens_a, labels_a, n_a = self._masked_piece(i, start_a, half, rng)
        if rng.random() < 0.5 and self.corpus.n_passages > 1:
            j = self._other_passage(i, rng)
            tokens_b, labels_b, _ = self._masked_piece(j, int(rng.integers(1 << 30)), half, rng)
            match = 0
        else:
            # the disjoint continuation: b starts after a's sentences; at the
            # passage's end it wraps to the head and stops before a's first
            # sentence; when a took the whole passage, another passage's
            # piece (match 0) takes its place
            n_sent = max(self.corpus.passage_n_sentences(i), 1)
            s0 = start_a % n_sent
            b_start = s0 + n_a
            if b_start < n_sent:
                tokens_b, labels_b, _ = self._masked_piece(i, b_start, half, rng)
            elif s0 > 0:
                tokens_b, labels_b, _ = self._masked_piece(i, 0, half, rng, stop_sent=s0)
            else:
                tokens_b, labels_b = [], []
            match = 1
            if not tokens_b:
                if self.corpus.n_passages > 1:
                    j = self._other_passage(i, rng)
                    tokens_b, labels_b, _ = self._masked_piece(j, int(rng.integers(1 << 30)), half, rng)
                    match = 0
                else:
                    # one exhausted passage: the duplicate cannot be avoided
                    tokens_b, labels_b, _ = self._masked_piece(i, s0, half, rng)
        enc = assemble_pair(tokens_a, tokens_b, self.tokenizer, T, lm_labels_a=labels_a, lm_labels_b=labels_b)
        return {"input_ids": enc.input_ids, "token_type_ids": enc.segment_ids, "input_mask": enc.input_mask,
                "masked_lm_labels": enc.lm_labels, "matched_label": np.int32(match)}

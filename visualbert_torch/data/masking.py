"""Masking, sequence assembly and answer scores: the part of
``visualbert_tpu/data/masking.py`` that ``CocoCaptionsDataset`` and
``VQADataset`` use, copied (importing the JAX package pulls in JAX).

  * ``random_word``: 15% MLM masking with the 80/10/10 mask/random/keep
    split and -1 labels elsewhere (reference ``fine_tuning.py:272-308``);
  * ``truncate_seq_pair``: longest-first pair truncation
    (``fine_tuning.py:624-637``);
  * ``assemble_pair``: ``[CLS] a [SEP] (b [SEP])`` with masks and segments
    (``bert_data_utils.py:85-140``);
  * ``compute_answer_scores``: VQA soft scores ``min(0.3 * count, 1)``
    (``bert_data_utils.py:421-429``).

Every function takes an explicit ``numpy.random.Generator``, so a (seed,
epoch, index) key reproduces any example, bit for bit with the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from visualbert_torch.data.tokenization import BertTokenizer

MLM_IGNORE = -1
MASK_PROB = 0.15  # share of tokens selected for MLM corruption


def _vocab_items(tokenizer) -> List[str]:
    """Vocab keys as a list, cached on the tokenizer (rebuilding the
    30522-entry list per sample was the masking hot spot)."""
    vi = getattr(tokenizer, "_vocab_items_cache", None)
    if vi is None:
        vi = list(tokenizer.vocab.keys())
        tokenizer._vocab_items_cache = vi
    return vi


def random_word(
    tokens: List[str],
    tokenizer: BertTokenizer,
    rng: np.random.Generator,
) -> Tuple[List[str], List[int]]:
    """Per-token MLM corruption. Returns (corrupted tokens, labels).

    The select/action/replacement draws are three array RNG calls and Python
    touches only the ~15% selected positions (the reference's 80/10/10
    distribution; the RNG stream is the JAX package's)."""
    n = len(tokens)
    out = list(tokens)
    labels = [MLM_IGNORE] * n
    if n == 0:
        return out, labels
    sel = np.flatnonzero(rng.random(n) < MASK_PROB)
    if len(sel) == 0:
        return out, labels
    p = rng.random(len(sel))
    vi = _vocab_items(tokenizer)
    repl = rng.integers(len(vi), size=len(sel))
    vocab_get = tokenizer.vocab.get
    unk = tokenizer.vocab["[UNK]"]
    for j, i in enumerate(sel.tolist()):
        pj = p[j]
        if pj < 0.8:
            out[i] = "[MASK]"
        elif pj < 0.9:
            out[i] = vi[int(repl[j])]
        # else: keep
        labels[i] = vocab_get(tokens[i], unk)
    return out, labels


def truncate_seq_pair(tokens_a: List[str], tokens_b: List[str], max_length: int) -> None:
    """In-place longest-first truncation (from the tail)."""
    while len(tokens_a) + len(tokens_b) > max_length:
        if len(tokens_a) > len(tokens_b):
            tokens_a.pop()
        else:
            tokens_b.pop()


@dataclasses.dataclass
class EncodedText:
    input_ids: np.ndarray       # [T] int32, zero-padded
    segment_ids: np.ndarray     # [T] int32
    input_mask: np.ndarray      # [T] int32
    lm_labels: np.ndarray       # [T] int32, -1 where unused


def assemble_pair(
    tokens_a: List[str],
    tokens_b: Optional[List[str]],
    tokenizer: BertTokenizer,
    max_seq_length: int,
    lm_labels_a: Optional[List[int]] = None,
    lm_labels_b: Optional[List[int]] = None,
) -> EncodedText:
    """``[CLS] a [SEP] (b [SEP])`` with zero-padding to max_seq_length; the
    MLM labels of the special tokens, and of a segment given none, are -1."""
    tokens = ["[CLS]"] + list(tokens_a) + ["[SEP]"]
    segments = [0] * len(tokens)
    labels = [MLM_IGNORE]
    labels += list(lm_labels_a) if lm_labels_a is not None else [MLM_IGNORE] * len(tokens_a)
    labels += [MLM_IGNORE]
    if tokens_b:
        tokens += list(tokens_b) + ["[SEP]"]
        segments += [1] * (len(tokens_b) + 1)
        labels += list(lm_labels_b) if lm_labels_b is not None else [MLM_IGNORE] * len(tokens_b)
        labels += [MLM_IGNORE]

    ids = tokenizer.convert_tokens_to_ids(tokens)
    if len(ids) > max_seq_length:
        raise ValueError(f"{len(ids)} tokens exceed max_seq_length {max_seq_length}")

    T = max_seq_length
    input_ids = np.zeros(T, np.int32)
    segment_ids = np.zeros(T, np.int32)
    input_mask = np.zeros(T, np.int32)
    lm = np.full(T, MLM_IGNORE, np.int32)
    n = len(ids)
    input_ids[:n] = ids
    segment_ids[:n] = segments
    input_mask[:n] = 1
    lm[:n] = labels
    return EncodedText(input_ids, segment_ids, input_mask, lm)


def compute_answer_scores(counts: np.ndarray) -> np.ndarray:
    """VQA soft score: min(0.3 * #annotators, 1.0)."""
    return np.minimum(0.3 * counts.astype(np.float32), 1.0)

"""Masking, sequence assembly and answer scores, copied from
``visualbert_tpu/data/masking.py`` (importing the JAX package pulls in JAX).

  * ``random_word``: 15% MLM masking with the 80/10/10 mask/random/keep
    split and -1 labels elsewhere (reference ``fine_tuning.py:272-308``);
  * ``random_word_wwm`` / ``random_word_wwm_pieces``: whole-word masking
    over words or over an already wordpieced stream (reference
    ``unsupervised_visualbert/src/pretrain/text_data.py:415-451``);
  * ``truncate_seq_pair``: longest-first pair truncation
    (``fine_tuning.py:624-637``); ``truncate_front`` keeps the end of an
    over-long sequence (``bert_data_utils.py:52-64``);
  * ``assemble_pair``: ``[CLS] a [SEP] (b [SEP])`` with masks and segments
    (``bert_data_utils.py:85-140``), and ``encode_single``, ``[CLS] a [SEP]``
    with tokens outside the vocabulary as [UNK];
  * ``random_mask_features``: 15% region-feature masking, 80% zero / 10%
    random / 10% keep, and ``in_batch_random_replace``, the batch-level
    hook that resolves the in-batch random branch (``lxmert_data.py:558-583,
    756-771``);
  * ``compute_answer_scores``: VQA soft scores ``min(0.3 * count, 1)``
    (``bert_data_utils.py:421-429``).

Every function takes an explicit ``numpy.random.Generator``, so a (seed,
epoch, index) key reproduces any example, bit for bit with the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

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
    mask_prob: float = MASK_PROB,
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
    sel = np.flatnonzero(rng.random(n) < mask_prob)
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


def _masked_groups(groups: Sequence[List[str]], tokenizer: BertTokenizer, rng: np.random.Generator,
                   mask_prob: float) -> Tuple[List[str], List[int]]:
    """One masking decision a group of wordpieces, applied to all of them."""
    vocab_items = _vocab_items(tokenizer)
    out_tokens: List[str] = []
    labels: List[int] = []
    for g in groups:
        if rng.random() < mask_prob:
            p = rng.random()
            for piece in g:
                if p < 0.8:
                    out_tokens.append("[MASK]")
                elif p < 0.9:
                    out_tokens.append(vocab_items[int(rng.integers(len(vocab_items)))])
                else:
                    out_tokens.append(piece)
                labels.append(tokenizer.vocab.get(piece, tokenizer.vocab["[UNK]"]))
        else:
            out_tokens.extend(g)
            labels.extend([MLM_IGNORE] * len(g))
    return out_tokens, labels


def random_word_wwm(
    words: Sequence[str],
    tokenizer: BertTokenizer,
    rng: np.random.Generator,
    mask_prob: float = MASK_PROB,
) -> Tuple[List[str], List[int]]:
    """Whole-word masking: decide per *word*, apply to all its wordpieces."""
    return _masked_groups([tokenizer.wordpiece.tokenize(w) for w in words], tokenizer, rng, mask_prob)


def random_word_wwm_pieces(
    pieces: Sequence[str],
    tokenizer: BertTokenizer,
    rng: np.random.Generator,
    mask_prob: float = MASK_PROB,
    group_continuations: bool = True,
) -> Tuple[List[str], List[int]]:
    """Whole-word masking over an already wordpieced stream (the packed
    corpus path). ``group_continuations``: ``##`` pieces share their word's
    decision; False is the reference's packed-text behaviour, where every
    piece decides alone (it feeds each piece back through the wordpiece
    tokenizer, which keeps ``##x`` as one piece)."""
    groups: List[List[str]] = []
    for p in pieces:
        if group_continuations and p.startswith("##") and groups:
            groups[-1].append(p)
        else:
            groups.append([p])
    return _masked_groups(groups, tokenizer, rng, mask_prob)


def truncate_seq_pair(tokens_a: List[str], tokens_b: List[str], max_length: int) -> None:
    """In-place longest-first truncation (from the tail)."""
    while len(tokens_a) + len(tokens_b) > max_length:
        if len(tokens_a) > len(tokens_b):
            tokens_a.pop()
        else:
            tokens_b.pop()


def truncate_front(tokens: List[str], max_length: int) -> List[str]:
    """Front truncation: the reference keeps the *end* of an over-long
    single sequence (``bert_data_utils.py:52-64``, cut_first='text')."""
    if len(tokens) > max_length:
        return tokens[len(tokens) - max_length:]
    return tokens


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


def encode_single(tokenizer: BertTokenizer, tokens: List[str], T: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """``[CLS] tokens [SEP]`` zero-padded to T, a token outside the
    vocabulary as [UNK]: (ids [T] int32, mask [T] int32, length)."""
    unk = tokenizer.vocab["[UNK]"]
    seq = [tokenizer.cls_id] + [tokenizer.vocab.get(t, unk) for t in tokens] + [tokenizer.sep_id]
    ids = np.zeros(T, np.int32)
    mask = np.zeros(T, np.int32)
    ids[:len(seq)] = seq
    mask[:len(seq)] = 1
    return ids, mask, len(seq)


def random_mask_features(
    feats: np.ndarray,
    rng: np.random.Generator,
    mask_prob: float = MASK_PROB,
    pool: Optional[np.ndarray] = None,
    in_batch_mark: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Region-feature masking (reference ``lxmert_data.py:558-583``).
    Returns (corrupted feats, mask), mask 1 at a masked region: 80% zeroed,
    10% random, 10% kept. The random branch with ``in_batch_mark`` leaves
    the feature as it is and marks the region 2.0, a transient mark that
    :func:`in_batch_random_replace` resolves at collate time; otherwise it
    copies a row of ``pool`` (default: the same image's regions)."""
    feats = feats.copy()
    n = feats.shape[0]
    mask = np.zeros(n, np.float32)
    if pool is None:
        pool = feats
    for i in range(n):
        if rng.random() < mask_prob:
            mask[i] = 1.0
            p = rng.random()
            if p < 0.8:
                feats[i] = 0.0
            elif p < 0.9:
                if in_batch_mark:
                    mask[i] = 2.0
                else:
                    feats[i] = pool[int(rng.integers(pool.shape[0]))]
    return feats, mask


def in_batch_random_replace(batch: dict, rng: np.random.Generator) -> dict:
    """Resolve the 2.0 marks of ``random_mask_features(in_batch_mark=True)``:
    each marked region takes the original (``feat_target``) feature of a
    random other region j != i of a random other example of the batch, and
    its mark drops to 1.0 (the reference's ``create_in_batch_random_feat``,
    ``lxmert_data.py:756-771``). Mutates and returns ``batch``."""
    fm = batch.get("feat_mask")
    if fm is None or not (fm == 2.0).any():
        return batch
    feats = batch["visual_feats"]
    target = batch["feat_target"]
    B, N = fm.shape
    if B < 2 or N < 2:  # no other example or region: the mark keeps the feature
        fm[fm == 2.0] = 1.0
        return batch
    for b, i in np.argwhere(fm == 2.0):
        ob = int(rng.integers(B - 1))
        if ob >= b:
            ob += 1
        oj = int(rng.integers(N - 1))
        if oj >= i:
            oj += 1
        feats[b, i] = target[ob, oj]
        fm[b, i] = 1.0
    return batch


def compute_answer_scores(counts: np.ndarray) -> np.ndarray:
    """VQA soft score: min(0.3 * #annotators, 1.0)."""
    return np.minimum(0.3 * counts.astype(np.float32), 1.0)

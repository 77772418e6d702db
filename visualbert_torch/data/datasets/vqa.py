"""VQA2 dataset (reference ``visualbert/dataloaders/vqa_dataset.py``):
``AnswerVocab``, ``VQADataset``, ``make_synthetic`` and ``VQAEvaluator`` of
``visualbert_tpu/data/datasets/vqa.py``, copied (importing the JAX package
pulls in JAX).

Text contract (vqa_dataset.py:220-230): ``[CLS] question ? [MASK] [SEP]``;
the classifier head reads the hidden state at the ``[MASK]`` slot (position
``sum(input_mask) - 2``). Targets are soft scores ``min(0.3 * count, 1)``
over the answer vocabulary (bert_data_utils.py:421-429).

The answer-as-MLM mode (``advanced``, task ``vqa_advanced``;
vqa_dataset.py:158-184): ``[CLS] question ? [MASK]... [SEP]``, one
``[MASK]`` per answer wordpiece (at most ``max_answer_tokens``, the
question cut to make room), ``masked_lm_labels`` holding their ids and
``mlm_positions`` a fixed budget of ``max_answer_tokens`` slot indices,
padded with position 0, whose label is -1.

Annotations are a list of dicts (the Pythia imdb contract,
vqa_dataset.py:55-64):
  {"question_tokens": [...], "image_id": str, "answers": [str, ...] (train),
   "question_id": int}
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from visualbert_torch.data.features import ChunkFeatures, FeatureStore
from visualbert_torch.data.masking import MLM_IGNORE, assemble_pair, compute_answer_scores
from visualbert_torch.data.pipeline import pad_regions
from visualbert_torch.data.tokenization import BertTokenizer


class AnswerVocab:
    """Answer-string -> index table (``vqa_dataset.py:323-344`` VocabDict)."""

    def __init__(self, words: Sequence[str]):
        self.word_list = list(words)
        self.word2idx = {w: i for i, w in enumerate(self.word_list)}

    @classmethod
    def from_file(cls, path: str) -> "AnswerVocab":
        with open(path) as f:
            if path.endswith(".json"):
                return cls(json.load(f))
            return cls([line.strip() for line in f if line.strip()])

    def __len__(self):
        return len(self.word_list)

    def get(self, word: str) -> Optional[int]:
        return self.word2idx.get(word)


class VQADataset:
    def __init__(
        self,
        annotations: List[Dict],
        features: FeatureStore,
        tokenizer: BertTokenizer,
        answer_vocab: Optional[AnswerVocab],
        *,
        max_seq_length: int = 128,
        max_regions: int = 100,
        with_labels: bool = True,
        advanced: bool = False,
        max_answer_tokens: int = 4,
    ):
        self.annotations = annotations
        self.features = features
        self.tokenizer = tokenizer
        self.answer_vocab = answer_vocab  # None in the advanced mode
        self.max_seq_length = max_seq_length
        self.max_regions = max_regions
        self.with_labels = with_labels
        self.advanced = advanced
        self.max_answer_tokens = max_answer_tokens

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, args) -> Dict[str, np.ndarray]:
        i, _ = args  # (index, rng): the example draws nothing at random
        item = self.annotations[i]
        tokens = self.tokenizer.tokenize(" ".join(item["question_tokens"]))
        if self.advanced:
            answer = item.get("answer_str") or (item.get("answers") or [""])[0]
            ans_tokens = self.tokenizer.tokenize(answer)[: self.max_answer_tokens]
            budget = self.max_seq_length - 2 - len(ans_tokens)
            tokens = tokens[: budget - 1] + ["?"]
            unk = self.tokenizer.vocab["[UNK]"]
            lm_labels = [MLM_IGNORE] * len(tokens) + [self.tokenizer.vocab.get(t, unk) for t in ans_tokens]
            enc = assemble_pair(tokens + ["[MASK]"] * len(ans_tokens), None, self.tokenizer, self.max_seq_length,
                                lm_labels)
        else:
            tokens = tokens + ["?", "[MASK]"]
            enc = assemble_pair(tokens[: self.max_seq_length - 2], None, self.tokenizer, self.max_seq_length)

        feat = self.features.get(str(item["image_id"]))["features"]
        visual, image_mask = pad_regions(feat, self.max_regions)

        sample = {
            "input_ids": enc.input_ids,
            "token_type_ids": enc.segment_ids,
            "input_mask": enc.input_mask,
            "visual_embeddings": visual,
            "image_mask": image_mask,
            "question_id": np.int64(item.get("question_id", i)),
        }
        if self.advanced:
            sample["masked_lm_labels"] = enc.lm_labels
            # the answer's [MASK] slots, gathered before the tied decoder
            pos = np.flatnonzero(enc.lm_labels != MLM_IGNORE)[: self.max_answer_tokens]
            positions = np.zeros(self.max_answer_tokens, np.int32)
            positions[: len(pos)] = pos
            sample["mlm_positions"] = positions
        elif self.with_labels and "answers" in item:  # a test split has none
            counts = np.zeros(len(self.answer_vocab), np.float32)
            for ans in item["answers"]:
                idx = self.answer_vocab.get(ans)
                if idx is not None:
                    counts[idx] += 1
            sample["label"] = compute_answer_scores(counts)
        return sample


def make_synthetic(n: int, tokenizer: BertTokenizer, n_answers: int = 16, n_regions: int = 10,
                   feat_dim: int = 32, seed: int = 0):
    """Small in-memory VQA task for tests and smoke runs: answers correlate
    with a token in the question, so accuracy is learnable. Returns
    (annotations, ChunkFeatures, AnswerVocab)."""
    rng = np.random.default_rng(seed)
    words = [w for w in tokenizer.vocab if not w.startswith("[") and not w.startswith("##")]
    # answers are real vocabulary words, as the answer-as-MLM mode needs
    answers = [words[-(i + 1)] for i in range(n_answers)]
    annotations, chunk = [], {}
    for i in range(n):
        a = int(rng.integers(n_answers))
        q = [words[a % len(words)]] + list(rng.choice(words, size=3))
        chunk[str(i)] = {"features": rng.normal(size=(n_regions, feat_dim)).astype(np.float32)}
        annotations.append({"question_tokens": q, "image_id": str(i), "answers": [answers[a]] * 4,
                            "answer_str": answers[a], "question_id": i})
    return annotations, ChunkFeatures(chunk), AnswerVocab(answers)


class VQAEvaluator:
    """The leaderboard dump (reference ``vqa_data.py:255-288``; result json:
    [{"question_id", "answer"}]). The soft-score accuracy is the model's
    ``accuracy`` output."""

    def __init__(self, answer_vocab: AnswerVocab):
        self.vocab = answer_vocab

    def dump(self, question_ids: Sequence[int], logits: np.ndarray, path: str):
        pred = logits.argmax(axis=-1)
        result = [{"question_id": int(q), "answer": self.vocab.word_list[int(p)]} for q, p in zip(question_ids, pred)]
        with open(path, "w") as f:
            json.dump(result, f)

"""Symbolic (detector-tag) vocabulary (counterpart of
``visualbert_tpu/data/symbolic.py``; reference
``unsupervised_visualbert/src/lxrt/symbolic_vocabulary.py:3-60``): object
classes, then attribute classes, then CLS, SEP and MASK (1600 + 400 + 3 =
2003 ids for BUTD's vocabularies).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from visualbert_torch.data.tokenization import BertTokenizer

_SPECIAL = ("[CLS]", "[SEP]", "[MASK]")


class SymbolicVocab:
    def __init__(self, objects: Sequence[str], attributes: Sequence[str]):
        self.objects = list(objects)
        self.attributes = list(attributes)
        self.n_obj = len(self.objects)
        self.n_attr = len(self.attributes)
        self.cls_id = self.n_obj + self.n_attr
        self.sep_id = self.cls_id + 1
        self.mask_id = self.cls_id + 2
        self.size = self.n_obj + self.n_attr + 3

    @classmethod
    def from_files(cls, objects_path: str, attributes_path: str) -> "SymbolicVocab":
        def read(p):
            with open(p) as f:
                # a BUTD vocabulary line may list comma-separated synonyms;
                # the reference keeps the first (symbolic_vocabulary.py:14-20)
                return [line.strip().split(",")[0] for line in f if line.strip()]

        return cls(read(objects_path), read(attributes_path))

    def obj_to_symbolic(self, obj_id: int) -> int:
        return obj_id

    def attr_to_symbolic(self, attr_id: int) -> int:
        return self.n_obj + attr_id

    def symbolic_to_word(self, sym_id: int) -> str:
        if sym_id < self.n_obj:
            return self.objects[sym_id]
        if sym_id < self.n_obj + self.n_attr:
            return self.attributes[sym_id - self.n_obj]
        return _SPECIAL[sym_id - self.n_obj - self.n_attr]

    def subword_lists(self, tokenizer: BertTokenizer) -> List[List[int]]:
        """Each symbol's wordpiece ids, to initialise the symbolic table as
        the mean of its word's subword embeddings (modeling.py:550-559)."""
        unk = tokenizer.vocab["[UNK]"]
        out = []
        for i in range(self.size):
            word = self.symbolic_to_word(i)
            if word in _SPECIAL:
                out.append([tokenizer.vocab[word]])
            else:
                pieces = tokenizer.tokenize(word) or ["[UNK]"]
                out.append([tokenizer.vocab.get(p, unk) for p in pieces])
        return out


def initialize_symbolic_embedding(word_embedding, subword_lists) -> np.ndarray:
    """The symbolic table as each symbol's mean subword embedding (numpy in,
    numpy out)."""
    word_embedding = np.asarray(word_embedding)
    return np.stack([word_embedding[ids].mean(axis=0) for ids in subword_lists], axis=0)

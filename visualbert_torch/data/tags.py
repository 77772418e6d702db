"""Detector-tag sequences and their joint masking (counterpart of
``visualbert_tpu/data/tags.py``; reference
``unsupervised_visualbert/src/pretrain/tag_data_utilis.py``).

A tag sequence is one symbolic token a region, the detector's object class
with attributes swapped in at ``insert_attr_ratio`` (tag_data_utilis.py:44-79),
carrying its region's box. Pretraining masks tags 15% (80/10/10); with
``tag_joint_mask_ratio`` a region whose feature is masked has its tag masked
with that probability too (tag_data_utilis.py:92-144), so the model cannot
copy one from the other.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from visualbert_torch.data.symbolic import SymbolicVocab

TAG_IGNORE = -1


def build_tags(obj_ids: np.ndarray, attr_ids: Optional[np.ndarray], boxes: np.ndarray, vocab: SymbolicVocab,
               rng: np.random.Generator, insert_attr_ratio: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """(tags [N], tag boxes [N, 4]) in symbolic ids from a region's object
    ids [N], attribute ids and normalised boxes [N, 4]."""
    tags = np.array([vocab.obj_to_symbolic(int(o)) for o in obj_ids], np.int32)
    if attr_ids is not None and insert_attr_ratio > 0:
        swap = rng.random(len(tags)) < insert_attr_ratio
        for i in np.flatnonzero(swap):
            tags[i] = vocab.attr_to_symbolic(int(attr_ids[i]))
    return tags, boxes.astype(np.float32)


def mask_tags(tags: np.ndarray, vocab: SymbolicVocab, rng: np.random.Generator, mask_prob: float = 0.15,
              feature_mask: Optional[np.ndarray] = None,
              tag_joint_mask_ratio: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """(corrupted tags, objective labels, -1 where a tag is not predicted)."""
    out = tags.copy()
    labels = np.full(len(tags), TAG_IGNORE, np.int32)
    for i in range(len(tags)):
        coupled = feature_mask is not None and feature_mask[i] > 0 and rng.random() < tag_joint_mask_ratio
        if coupled or rng.random() < mask_prob:
            labels[i] = tags[i]
            p = rng.random()
            if p < 0.8:
                out[i] = vocab.mask_id
            elif p < 0.9:
                out[i] = int(rng.integers(vocab.n_obj + vocab.n_attr))
    return out, labels

"""Unsupervised V&L pretraining dataset (counterpart of
``visualbert_tpu/data/datasets/unsup_pretrain.py``; reference
``unsupervised_visualbert/src/pretrain/lxmert_data.py``). Examples are
byte-identical to the JAX package's.

An example pairs a sentence, possibly unaligned (the point of the NAACL-2021
paper), with an image's region features and detector tags:

  * matched objective: half the time the sentence is swapped for a random
    one, ``matched_label`` 1 aligned, 0 random (lxmert_data.py:513-527);
  * text MLM 15% 80/10/10 (lxmert_data.py:170-218);
  * feature masking 15%: 80% zeroed, 10% random, 10% kept; the loss target
    is the original feature, weighted by the detector's confidence
    (lxmert_data.py:558-583); with ``inbatch_random`` the random branch
    takes another example's feature through the Batcher's
    ``batch_transform`` hook (lxmert_data.py:756-771);
  * tags from the object and attribute ids, masked jointly with the
    features (tag_data_utilis.py:92-144);
  * image-only mode (no text fields) and QA answers when given.

Annotations: [{"image_id", "sentence" (optional), "ans" (int, optional)}].
A feature store row: {"features" [N, D], "boxes" [N, 4] pixels,
"objects_id" [N], "objects_conf" [N], "attrs_id" [N], "attrs_conf" [N],
"img_h", "img_w"}.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from visualbert_torch.data.features import ChunkFeatures, FeatureStore, normalize_boxes
from visualbert_torch.data.masking import (MASK_PROB, MLM_IGNORE, encode_single, in_batch_random_replace,
                                           random_mask_features, random_word)
from visualbert_torch.data.symbolic import SymbolicVocab
from visualbert_torch.data.tags import build_tags, mask_tags
from visualbert_torch.data.tokenization import BertTokenizer


class UnsupervisedPretrainDataset:
    def __init__(self, annotations: List[Dict], features: FeatureStore, tokenizer: BertTokenizer,
                 symbolic_vocab: SymbolicVocab, *, max_seq_length: int = 30, n_regions: int = 36,
                 mask_prob: float = MASK_PROB, feature_mask_prob: float = MASK_PROB, matched_prob: float = 0.5,
                 insert_attr_ratio: float = 0.15, tag_joint_mask_ratio: float = 0.5, image_only: bool = False,
                 text_available: bool = True, inbatch_random: bool = True):
        self.annotations = annotations
        self.features = features
        self.tokenizer = tokenizer
        self.symbolic_vocab = symbolic_vocab
        self.max_seq_length = max_seq_length
        self.n_regions = n_regions
        self.mask_prob = mask_prob
        self.feature_mask_prob = feature_mask_prob
        self.matched_prob = matched_prob
        self.insert_attr_ratio = insert_attr_ratio
        self.tag_joint_mask_ratio = tag_joint_mask_ratio
        self.image_only = image_only
        self.text_available = text_available
        # the reference's headline config runs inbatch_random
        # (configs/pretrain/unsupervised.json:55)
        self.inbatch_random = inbatch_random

    @property
    def batch_transform(self):
        return in_batch_random_replace if self.inbatch_random else None

    def __len__(self):
        return len(self.annotations)

    def _encode_text(self, sentence: str, rng) -> Dict[str, np.ndarray]:
        T = self.max_seq_length
        tokens = self.tokenizer.tokenize(sentence)[: T - 2]
        tokens, labels = random_word(tokens, self.tokenizer, rng, self.mask_prob)
        ids, mask, n = encode_single(self.tokenizer, tokens, T)
        lm = np.full(T, MLM_IGNORE, np.int32)
        lm[1: n - 1] = labels
        return {"input_ids": ids, "token_type_ids": np.zeros(T, np.int32), "input_mask": mask,
                "masked_lm_labels": lm}

    def __getitem__(self, args) -> Dict[str, np.ndarray]:
        i, rng = args
        item = self.annotations[i]
        row = self.features.get(str(item["image_id"]))
        N = self.n_regions

        feats = np.asarray(row["features"], np.float32)[:N]
        boxes = normalize_boxes(np.asarray(row["boxes"], np.float32)[:N], float(row.get("img_h", 1.0)),
                                float(row.get("img_w", 1.0)))
        obj_ids = np.asarray(row.get("objects_id", np.zeros(N)), np.int64)[:N]
        obj_conf = np.asarray(row.get("objects_conf", np.ones(N)), np.float32)[:N]
        attr_ids = np.asarray(row.get("attrs_id", np.zeros(N)), np.int64)[:N]
        attr_conf = np.asarray(row.get("attrs_conf", np.ones(N)), np.float32)[:N]

        # the target is the original features; in-batch random slots carry
        # the transient 2.0 mark, which the confidences must not see
        corrupted, feat_mask = random_mask_features(feats, rng, self.feature_mask_prob,
                                                    in_batch_mark=self.inbatch_random)
        feat_masked = np.minimum(feat_mask, 1.0)
        tags, tag_boxes = build_tags(obj_ids, attr_ids, boxes, self.symbolic_vocab, rng, self.insert_attr_ratio)
        tags_corrupt, tags_objective = mask_tags(tags, self.symbolic_vocab, rng, self.mask_prob,
                                                 feature_mask=feat_mask,
                                                 tag_joint_mask_ratio=self.tag_joint_mask_ratio)
        sample: Dict[str, np.ndarray] = {
            "visual_feats": corrupted,
            "boxes": boxes,
            "visual_feats_mask": np.ones(N, np.int32),
            "obj_labels": np.where(feat_mask > 0, obj_ids, -1).astype(np.int32),
            "obj_conf": (obj_conf * feat_masked).astype(np.float32),
            "attr_labels": np.where(feat_mask > 0, attr_ids, -1).astype(np.int32),
            "attr_conf": (attr_conf * feat_masked).astype(np.float32),
            "feat_target": feats,
            "feat_mask": feat_mask,
            "visual_tags": tags_corrupt.astype(np.int32),
            "visual_tags_box": tag_boxes,
            "visual_tags_mask": np.ones(N, np.int32),
            "visual_tags_objective": tags_objective,
        }
        if not self.image_only and self.text_available and item.get("sentence") is not None:
            sentence = item["sentence"]
            matched = 1
            if self.matched_prob > 0 and rng.random() < self.matched_prob:
                j = int(rng.integers(len(self.annotations)))
                other = self.annotations[j].get("sentence")
                if other is not None and j != i:
                    sentence = other
                    matched = 0
            sample.update(self._encode_text(sentence, rng))
            sample["matched_label"] = np.int32(matched)
            # the QA answer of matched pairs only; a string answer must have
            # been mapped through an AnswerTable (tasks/registry.py)
            a = item.get("ans", -1) if matched else -1
            sample["ans"] = np.int32(a if isinstance(a, (int, np.integer)) else -1)
        return sample


def make_synthetic(n: int, tokenizer: BertTokenizer, symbolic_vocab: SymbolicVocab, n_regions: int = 6,
                   feat_dim: int = 16, seed: int = 0, answers: int = 0):
    """(annotations, ChunkFeatures) of ``n`` images, the JAX package's set:
    a feature channel a region marks its object id (so objects are
    learnable), the sentence repeats a word picked by the first object.
    ``answers > 0`` attaches a QA answer string "a<k>", k the first object
    id mod ``answers`` (reference ans field, lxmert_data.py:105-141)."""
    rng = np.random.default_rng(seed)
    words = [w for w in tokenizer.vocab if not w.startswith("[") and not w.startswith("##")]
    annotations, chunk = [], {}
    for i in range(n):
        obj = rng.integers(0, symbolic_vocab.n_obj, size=n_regions)
        feats = rng.normal(size=(n_regions, feat_dim)).astype(np.float32)
        for r in range(n_regions):
            feats[r, int(obj[r]) % feat_dim] += 4.0
        boxes = np.sort(np.abs(rng.normal(size=(n_regions, 4))).astype(np.float32), axis=-1)
        chunk[str(i)] = {
            "features": feats,
            "boxes": boxes * 10,
            "objects_id": obj,
            "objects_conf": np.ones(n_regions, np.float32),
            "attrs_id": rng.integers(0, symbolic_vocab.n_attr, size=n_regions),
            "attrs_conf": np.ones(n_regions, np.float32) * 0.5,
            "img_h": 10.0,
            "img_w": 10.0,
        }
        item = {"image_id": str(i), "sentence": " ".join([words[int(obj[0]) % len(words)]] * 5)}
        if answers:
            item["ans"] = f"a{int(obj[0]) % answers}"
        annotations.append(item)
    return annotations, ChunkFeatures(chunk)

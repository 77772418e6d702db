"""COCO-caption pretraining dataset (reference
``visualbert/dataloaders/coco_dataset.py``): ``CocoCaptionsDataset``,
``CocoDetectorDataset`` (the raw-image detector path), ``expand_coco``,
``make_synthetic`` and ``make_synthetic_detector`` of
``visualbert_tpu/data/datasets/coco.py``, copied (importing the JAX package
pulls in JAX).

Two text modes:
  * ``two_sentence`` (coco_dataset.py:195-208): caption A from the image,
    caption B 50% true continuation / 50% random caption from another image;
    ``is_random_next`` is the sentence-image-alignment label (0 = aligned
    pair, 1 = random);
  * single-caption with ``false_caption_ratio`` (coco_dataset.py:209-221):
    one caption, possibly swapped for a random one.

Both apply 15% 80/10/10 MLM masking and emit the fixed-budget
``mlm_positions`` used by the gathered MLM head.

Annotations: [{"image_id": str, "captions": [str, ...]}].
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from visualbert_torch.data.features import ChunkFeatures, FeatureStore
from visualbert_torch.data.masking import MLM_IGNORE, assemble_pair, random_word, truncate_seq_pair
from visualbert_torch.data.pipeline import pad_regions, pad_to
from visualbert_torch.data.tokenization import BertTokenizer
from visualbert_torch.utils.images import image_wire_fields

FALSE_CAPTION_RATIO = 0.5  # single-caption mode: share of swapped captions
N_MLM_PREDICTIONS = 24     # fixed budget of gathered MLM slots per example


class CocoCaptionsDataset:
    def __init__(
        self,
        annotations: List[Dict],
        features: FeatureStore,
        tokenizer: BertTokenizer,
        *,
        max_seq_length: int = 128,
        max_regions: int = 100,
        two_sentence: bool = True,
    ):
        self.annotations = annotations
        self.features = features
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.max_regions = max_regions
        self.two_sentence = two_sentence

    def __len__(self):
        return len(self.annotations)

    def _random_other_caption(self, rng, exclude: int) -> str:
        while True:
            j = int(rng.integers(len(self.annotations)))
            if j != exclude:
                caps = self.annotations[j]["captions"]
                return caps[int(rng.integers(len(caps)))]

    def _encode_captions(self, i, rng):
        """Caption sampling + MLM masking + pair assembly -> (EncodedText,
        is_random_next, gathered mlm positions)."""
        item = self.annotations[i]
        caps = item["captions"]

        if self.two_sentence:
            a = caps[int(rng.integers(len(caps)))]
            if rng.random() < 0.5:
                b = self._random_other_caption(rng, i)
                is_random_next = 1
            else:
                others = [c for c in caps if c != a] or caps
                b = others[int(rng.integers(len(others)))]
                is_random_next = 0
            tok_a = self.tokenizer.tokenize(a)
            tok_b = self.tokenizer.tokenize(b)
            truncate_seq_pair(tok_a, tok_b, self.max_seq_length - 3)
            tok_a, lbl_a = random_word(tok_a, self.tokenizer, rng)
            tok_b, lbl_b = random_word(tok_b, self.tokenizer, rng)
            enc = assemble_pair(tok_a, tok_b, self.tokenizer, self.max_seq_length, lbl_a, lbl_b)
        else:
            if rng.random() < FALSE_CAPTION_RATIO:
                text = self._random_other_caption(rng, i)
                is_random_next = 1
            else:
                text = caps[int(rng.integers(len(caps)))]
                is_random_next = 0
            tokens = self.tokenizer.tokenize(text)[: self.max_seq_length - 2]
            tokens, labels = random_word(tokens, self.tokenizer, rng)
            enc = assemble_pair(tokens, None, self.tokenizer, self.max_seq_length, labels)

        # fixed-budget masked-position index for the gathered MLM head;
        # pad slots point at position 0 ([CLS], label -1 there)
        pos = np.flatnonzero(enc.lm_labels != MLM_IGNORE)[:N_MLM_PREDICTIONS]
        positions = np.zeros(N_MLM_PREDICTIONS, np.int32)
        positions[: len(pos)] = pos
        return enc, is_random_next, positions

    def __getitem__(self, args) -> Dict[str, np.ndarray]:
        i, rng = args
        item = self.annotations[i]
        enc, is_random_next, positions = self._encode_captions(i, rng)

        feat = self.features.get(str(item["image_id"]))["features"]
        visual, image_mask = pad_regions(feat, self.max_regions)

        return {
            "input_ids": enc.input_ids,
            "token_type_ids": enc.segment_ids,
            "input_mask": enc.input_mask,
            "masked_lm_labels": enc.lm_labels,
            "mlm_positions": positions,
            "is_random_next": np.int32(is_random_next),
            "visual_embeddings": visual,
            "image_mask": image_mask,
        }


class CocoDetectorDataset(CocoCaptionsDataset):
    """COCO captions through the raw-image detector path (the reference's
    ``r2c`` image_feature_type, coco_dataset.py:235-340): the image, its
    detection boxes and masks scaled to the canvas, the full-image window
    row prepended with an all-ones 14 x 14 mask and the ``__background__``
    class 0 (coco_dataset.py:276-279), and the detector-model batch
    (images, image_hw, boxes, box_mask, classes, segms) beside the MLM and
    sentence-image alignment text fields. The VCR pipeline's COCO
    pretraining stage (configs/vcr/coco-pre-train.json).

    ``images`` is an ``ImageFolderStore``-like reader returning {"image",
    "boxes", "classes", "segms", "height", "width"} in canvas coordinates."""

    def __init__(self, annotations, images, tokenizer, *, max_boxes: int = 20, **kw):
        super().__init__(annotations, features=None, tokenizer=tokenizer, **kw)
        self.images = images
        self.max_boxes = max_boxes

    def __getitem__(self, args) -> Dict[str, np.ndarray]:
        i, rng = args
        item = self.annotations[i]
        enc, is_random_next, positions = self._encode_captions(i, rng)

        img = self.images.get(str(item["image_id"]))
        N = self.max_boxes
        # the window is the content extent, not the padded canvas
        # (coco_dataset.py:276-279)
        h = int(img.get("height", img["image"].shape[0]))
        w = int(img.get("width", img["image"].shape[1]))
        window = np.asarray([[0.0, 0.0, w - 1.0, h - 1.0]], np.float32)
        boxes = np.concatenate([window, np.asarray(img["boxes"], np.float32)])[:N]
        classes = np.concatenate([[0], np.asarray(img["classes"], np.int64)]).astype(np.int32)[:N]
        segms_src = img.get("segms")
        if segms_src is None:
            segms_src = np.zeros((len(img["boxes"]), 14, 14), np.float32)
        segms = np.concatenate([np.ones((1, 14, 14), np.float32), np.asarray(segms_src, np.float32)])[:N]
        box_mask = np.zeros(N, np.int32)
        box_mask[: len(boxes)] = 1
        return {
            **image_wire_fields(img),
            "boxes": pad_to(boxes, N, axis=0),
            "box_mask": box_mask,
            "classes": pad_to(classes, N, axis=0),
            "segms": pad_to(segms, N, axis=0),
            "input_ids": enc.input_ids,
            "token_type_ids": enc.segment_ids,
            "input_mask": enc.input_mask,
            "masked_lm_labels": enc.lm_labels,
            "mlm_positions": positions,
            "is_random_next": np.int32(is_random_next),
        }


def expand_coco(train_annotations: List[Dict], val_annotations: List[Dict], minival_image_ids: List,
                exclude_minival: bool = True):
    """The reference's ``expand_coco`` (coco_dataset.py:422-441): train
    becomes train + val, optionally minus the VQA minival images; val shrinks
    to exactly the minival images. Returns (train, val)."""
    mini = {str(x) for x in minival_image_ids}
    extra = val_annotations
    if exclude_minival:
        extra = [a for a in val_annotations if str(a["image_id"]) not in mini]
    train = list(train_annotations) + list(extra)
    val = [a for a in val_annotations if str(a["image_id"]) in mini]
    return train, val


def make_synthetic_detector(n: int, tokenizer: BertTokenizer, img_size: int = 32, n_boxes: int = 3, seed: int = 0):
    """Toy raw-image COCO captions for the detector-path pretraining task:
    (annotations, an image store shaped like ``ImageFolderStore.get``)."""
    rng = np.random.default_rng(seed)
    words = [w for w in tokenizer.vocab if not w.startswith("[") and not w.startswith("##")]
    annotations, chunk = [], {}
    for i in range(n):
        img = rng.normal(size=(img_size, img_size, 3)).astype(np.float32) * 0.1
        boxes = np.zeros((n_boxes, 4), np.float32)
        for b in range(n_boxes):
            x = rng.uniform(0, img_size - 12)
            y = rng.uniform(0, img_size - 12)
            boxes[b] = [x, y, x + 10, y + 10]
        chunk[str(i)] = {
            "image": img,
            "boxes": boxes,
            "classes": rng.integers(1, 81, size=n_boxes),
            "segms": rng.random((n_boxes, 14, 14)).astype(np.float32),
        }
        caps = [" ".join(words[int(rng.integers(len(words)))] for _ in range(6)) for _ in range(3)]
        annotations.append({"image_id": str(i), "captions": caps})
    return annotations, ChunkFeatures(chunk)


def make_synthetic(n: int, tokenizer: BertTokenizer, feat_dim: int = 32):
    """``n`` toy images with 3 captions each and 10 random regions of
    ``feat_dim`` features: (annotations, ChunkFeatures)."""
    rng = np.random.default_rng(0)
    words = [w for w in tokenizer.vocab if not w.startswith("[") and not w.startswith("##")]
    annotations, chunk = [], {}
    for i in range(n):
        # structured captions (one theme word repeated) so MLM is solvable
        # from context and NSP from theme agreement between the two sentences
        w = words[int(rng.integers(len(words)))]
        caps = [" ".join([w] * 6) for _ in range(3)]
        chunk[str(i)] = {"features": rng.normal(size=(10, feat_dim)).astype(np.float32)}
        annotations.append({"image_id": str(i), "captions": caps})
    return annotations, ChunkFeatures(chunk)

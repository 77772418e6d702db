"""Region-feature stores, confidence screening and box normalisation: the
per-image ``.npy`` folder, the in-memory chunk, ``screen_features`` and
``normalize_boxes`` of ``visualbert_tpu/data/features.py``, copied
(importing the JAX package pulls in JAX). ``H5Features`` is not ported:
``h5py`` is not on the card's machine (ROADMAP.md A6).

Readers return fp32 features [n_boxes, dim] plus optional metadata and are
safe to share across the Batcher's threads.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np


class FeatureStore:
    def get(self, image_id: str) -> Dict[str, np.ndarray]:
        """{"features": [n_boxes, dim] fp32, ...metadata} of an image."""
        raise NotImplementedError


class NpyFolderFeatures(FeatureStore):
    """Directory of ``<image_id>.npy`` feature arrays, optionally with a
    sibling ``<image_id>_info.npy`` dict (boxes etc.)."""

    def __init__(self, folder: str):
        self.folder = folder

    def get(self, image_id: str) -> Dict[str, np.ndarray]:
        feats = np.load(os.path.join(self.folder, f"{image_id}.npy"), allow_pickle=True)
        if feats.dtype == object:  # dict-style npy
            d = feats.item()
            return {k: np.asarray(v) for k, v in d.items()}
        out = {"features": np.asarray(feats, np.float32)}
        info_path = os.path.join(self.folder, f"{image_id}_info.npy")
        if os.path.exists(info_path):
            info = np.load(info_path, allow_pickle=True).item()
            for k, v in info.items():
                out[k] = np.asarray(v)
        return out


class ChunkFeatures(FeatureStore):
    """In-memory chunk: {image_id: {features, boxes, ...}} (the reference's
    preloaded "one giant file" pattern; the synthetic sets use it)."""

    def __init__(self, chunk: Dict[str, Dict[str, np.ndarray]]):
        self.chunk = chunk

    def get(self, image_id: str) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in self.chunk[image_id].items()}


def screen_features(
    feats: np.ndarray,
    conf: Optional[np.ndarray],
    threshold: float = 0.2,
    max_cap: int = 300,
    min_count: int = 1,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Confidence screening (reference ``bert_data_utils.py:494-525``): keep
    the boxes with conf >= threshold in descending confidence, at least
    ``min_count``, at most ``max_cap``; without confidences the first
    ``max_cap``."""
    if conf is None:
        return feats[:max_cap], None
    order = np.argsort(-conf)
    keep = [i for i in order if conf[i] >= threshold]
    if len(keep) < min_count:
        keep = list(order[:min_count])
    keep = np.asarray(keep[:max_cap], np.int64)
    return feats[keep], conf[keep]


def normalize_boxes(boxes: np.ndarray, img_h: float, img_w: float) -> np.ndarray:
    """(x1, y1, x2, y2) pixel boxes -> [0, 1] coordinates, clipped (the
    unsupervised stack's contract, reference ``lxmert_data.py:483-490``)."""
    out = boxes.astype(np.float32).copy()
    out[:, (0, 2)] /= img_w
    out[:, (1, 3)] /= img_h
    np.clip(out, 0.0, 1.0 + 1e-5, out)
    return out

"""Region-feature stores, confidence screening and box normalisation: the
per-image ``.npy`` folder, the in-memory chunk, the BUTD HDF5 file and a
first-store-wins concatenation, ``screen_features`` and ``normalize_boxes``
of ``visualbert_tpu/data/features.py``, copied (importing the JAX package
pulls in JAX). ``H5Features`` imports ``h5py`` when it first reads; without
it that read raises an ImportError naming h5py.

Readers return fp32 features [n_boxes, dim] plus optional metadata and are
safe to share across the Batcher's threads (an HDF5 handle a thread).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class FeatureStore:
    def get(self, image_id: str) -> Dict[str, np.ndarray]:
        """{"features": [n_boxes, dim] fp32, ...metadata} of an image."""
        raise NotImplementedError

    def __contains__(self, image_id: str) -> bool:
        raise NotImplementedError


class NpyFolderFeatures(FeatureStore):
    """Directory of ``<image_id>.npy`` feature arrays, optionally with a
    sibling ``<image_id>_info.npy`` dict (boxes etc.)."""

    def __init__(self, folder: str):
        self.folder = folder

    def __contains__(self, image_id: str) -> bool:
        return os.path.exists(os.path.join(self.folder, f"{image_id}.npy"))

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

    def __contains__(self, image_id: str) -> bool:
        return image_id in self.chunk

    def get(self, image_id: str) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in self.chunk[image_id].items()}


H5_KEYS = ("boxes", "objects_id", "objects_conf", "attrs_id", "attrs_conf", "img_h", "img_w")


class H5Features(FeatureStore):
    """BUTD-style HDF5 (reference ``h5_data.py:225-387``): datasets
    ``features`` [N, boxes, D] and, where present, ``boxes`` [N, boxes, 4],
    ``objects_id``, ``objects_conf``, ``attrs_id``, ``attrs_conf`` and the
    image sizes ``img_h``, ``img_w``; image id -> row from ``ids`` or the
    sidecar ``<file>_ids.json`` (a json list) or ``<file>_ids.txt`` (one id a
    line). Each thread opens its own read handle."""

    def __init__(self, h5_path: str, ids: Optional[Sequence[str]] = None):
        self.h5_path = h5_path
        self._local = threading.local()
        if ids is None:
            ids = self._load_sidecar_ids(h5_path)
        self.index = {str(img_id): i for i, img_id in enumerate(ids)}

    @staticmethod
    def _load_sidecar_ids(h5_path: str) -> List[str]:
        base = os.path.splitext(h5_path)[0]
        if os.path.exists(base + "_ids.json"):
            with open(base + "_ids.json") as f:
                return [str(x) for x in json.load(f)]
        if os.path.exists(base + "_ids.txt"):
            with open(base + "_ids.txt") as f:
                return [line.strip() for line in f if line.strip()]
        raise FileNotFoundError(f"no id sidecar for {h5_path}")

    @property
    def _h5(self):
        if not hasattr(self._local, "f"):
            try:
                import h5py
            except ImportError as e:
                raise ImportError(f"reading {self.h5_path} needs h5py, which is not installed") from e
            self._local.f = h5py.File(self.h5_path, "r")
        return self._local.f

    def __contains__(self, image_id: str) -> bool:
        return str(image_id) in self.index

    def get(self, image_id: str) -> Dict[str, np.ndarray]:
        i = self.index[str(image_id)]
        f = self._h5
        out = {"features": np.asarray(f["features"][i], np.float32)}
        for k in H5_KEYS:
            if k in f:
                out[k] = np.asarray(f[k][i])
        return out


class ConcatFeatures(FeatureStore):
    """Several stores as one: the first that holds an id serves it
    (reference ``ConcateH5``, h5_data.py:154-168)."""

    def __init__(self, stores: Sequence[FeatureStore]):
        self.stores = list(stores)

    def __contains__(self, image_id: str) -> bool:
        return any(image_id in s for s in self.stores)

    def get(self, image_id: str) -> Dict[str, np.ndarray]:
        for s in self.stores:
            if image_id in s:
                return s.get(image_id)
        raise KeyError(image_id)


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

"""Feature extraction with the port's detector (counterpart of
``visualbert_tpu/tools/extract_features.py``, which replaces the
reference's offline Detectron / BUTD pipelines).

Runs ``SimpleDetector(semantic=False)`` (ResNet50 trunk + RoIAlign + layer4)
over batches of images with given proposal boxes and writes one
``<image_id>.npy`` an image of the per-box ``obj_reps_raw`` (2048-d), which
``NpyFolderFeatures`` reads back.
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np
import torch


def extract_to_folder(
    images_and_boxes: Iterable[Tuple[str, np.ndarray, np.ndarray]],
    out_dir: str,
    detector=None,
    batch_size: int = 8,
    image_size: int = 768,
    max_boxes: int = 36,
    seed: int = 0,
    device="cuda",
) -> int:
    """``images_and_boxes`` yields (image_id, image [H, W, 3] float, boxes
    [n, 4] in its pixels). ``detector`` is a ``SimpleDetector(semantic=False)``
    with its weights (``load_state`` of ``export_resnet50_state_dict``'s
    output, say); without one, a ResNet50 detector in bf16 with weights
    seeded from ``seed``. It runs on ``device``. Each image is resized
    nearest-neighbour on the host so its long side is ``image_size`` (its
    boxes scaled alike) into a zero canvas. Writes
    ``<out_dir>/<image_id>.npy`` [n, 2048] fp32 of the first ``max_boxes``
    boxes; returns the image count."""
    from visualbert_torch.models.detector import SimpleDetector

    os.makedirs(out_dir, exist_ok=True)
    if detector is None:
        detector = SimpleDetector(final_dim=2048, semantic=False).init_weights(torch.Generator().manual_seed(seed))
    det = detector.to(device).eval()
    count = 0

    def flush(buf):
        nonlocal count
        B = len(buf)
        images = np.zeros((B, image_size, image_size, 3), np.float32)
        boxes = np.zeros((B, max_boxes, 4), np.float32)
        mask = np.zeros((B, max_boxes), np.int32)
        kept = []
        for i, (image_id, img, bx) in enumerate(buf):
            h, w = img.shape[:2]
            s = image_size / max(h, w)
            yi = np.clip((np.arange(int(h * s)) / s).astype(int), 0, h - 1)
            xi = np.clip((np.arange(int(w * s)) / s).astype(int), 0, w - 1)
            images[i, : len(yi), : len(xi)] = img[yi][:, xi]
            n = min(len(bx), max_boxes)
            boxes[i, :n] = bx[:n] * s
            mask[i, :n] = 1
            kept.append((image_id, n))
        with torch.no_grad():
            reps = det(*(torch.as_tensor(x, device=device) for x in (images, boxes, mask)))["obj_reps_raw"]
        reps = reps.float().cpu().numpy()
        for i, (image_id, n) in enumerate(kept):
            np.save(os.path.join(out_dir, f"{image_id}.npy"), reps[i, :n])
            count += 1

    buf = []
    for item in images_and_boxes:
        buf.append(item)
        if len(buf) == batch_size:
            flush(buf)
            buf = []
    if buf:
        flush(buf)
    return count

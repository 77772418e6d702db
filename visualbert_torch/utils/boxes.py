"""Box / segmentation-mask geometry (``visualbert_tpu/utils/boxes.py``,
copied; reference ``visualbert/dataloaders/box_utils.py`` +
``mask_utils.py``).

* image resize bookkeeping (scale + padded window) for the VCR r2c path,
* polygon → soft 14×14 mask rasterization (``mask_utils.py:12-27`` —
  matplotlib-free: even-odd point-in-polygon test over subsampled cells).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def resize_plan(h: int, w: int, target: int = 768) -> Tuple[float, Tuple[int, int]]:
    """Scale so the long side == target; returns (scale, (new_h, new_w))."""
    scale = target / max(h, w)
    return scale, (int(round(h * scale)), int(round(w * scale)))


def scale_boxes(boxes: np.ndarray, scale: float) -> np.ndarray:
    return boxes.astype(np.float32) * scale


def clip_boxes(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    out = boxes.astype(np.float32).copy()
    out[:, 0::2] = np.clip(out[:, 0::2], 0, w - 1)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, h - 1)
    return out


def _points_in_polygon(xs: np.ndarray, ys: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Even-odd rule for arrays of points against one polygon [V, 2]."""
    inside = np.zeros(xs.shape, bool)
    n = len(poly)
    j = n - 1
    for i in range(n):
        xi, yi = poly[i]
        xj, yj = poly[j]
        crosses = ((yi > ys) != (yj > ys)) & (
            xs < (xj - xi) * (ys - yi) / (yj - yi + 1e-12) + xi
        )
        inside ^= crosses
        j = i
    return inside


def make_mask(
    polygons: Sequence[np.ndarray],
    box: Sequence[float],
    mask_size: int = 14,
    subsample: int = 4,
) -> np.ndarray:
    """Soft [mask_size, mask_size] coverage of `polygons` (image coords)
    within `box` (x1,y1,x2,y2): each cell's value is the fraction of its
    subsample×subsample grid points inside any polygon."""
    x1, y1, x2, y2 = box
    w = max(x2 - x1, 1e-6)
    h = max(y2 - y1, 1e-6)
    s = mask_size * subsample
    gx = x1 + (np.arange(s) + 0.5) / s * w
    gy = y1 + (np.arange(s) + 0.5) / s * h
    xs, ys = np.meshgrid(gx, gy)
    covered = np.zeros(xs.shape, bool)
    for poly in polygons:
        poly = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(poly) >= 3:
            covered |= _points_in_polygon(xs, ys, poly)
    soft = covered.reshape(mask_size, subsample, mask_size, subsample)
    return soft.mean(axis=(1, 3)).astype(np.float32)

"""Image loading for the end-to-end detector path
(``visualbert_tpu/utils/images.py``, copied; reference
``visualbert/dataloaders/box_utils.py:12-74`` load/resize/normalize).

Images are resized so the long side equals ``target`` and normalized with
the torchvision ImageNet statistics the reference backbone was trained with.
Output is HWC, uint8 on the wire (``device_normalize``, the default: the
detector normalizes on the device) or float32. PIL is imported where an
image is read, never at import: the synthetic paths do not need it, and
without it :func:`load_image`, :func:`resize_image`, :func:`prepare_image`
and ``ImageFolderStore.get`` raise an ImportError that names it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _pil_image():
    """PIL's ``Image`` module, imported at first use."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading image files needs PIL (the Pillow package), which is not installed") from e
    return Image


def load_image(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB."""
    Image = _pil_image()

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def resize_image(img: np.ndarray, target: int = 768) -> Tuple[np.ndarray, float]:
    """Resize long side to ``target`` (bilinear); returns (image, scale)."""
    Image = _pil_image()

    h, w = img.shape[:2]
    scale = target / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pil = Image.fromarray(img).resize((nw, nh), Image.BILINEAR)
    return np.asarray(pil), scale


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 RGB → normalized float32."""
    return (img.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD


def prepare_image(
    path: str,
    target: int = 768,
    pad_square: bool = True,
    normalize: bool = True,
    draft: bool = True,
) -> Dict[str, np.ndarray]:
    """Load → resize → (optionally) normalize → (optionally) pad to
    target×target. Returns {"image", "scale", "height", "width"} — boxes in
    original pixel coords multiply by ``scale`` to match.

    ``normalize=False`` keeps the image uint8 — the wire format for the
    raw-image path (4× fewer host→device bytes than fp32; the detector
    normalizes in-graph and re-zeros the padding from (height, width), so
    numerics match the host-normalized path).

    ``draft=True`` lets libjpeg decode at a DCT-scaled 1/2, 1/4 or 1/8
    resolution when the resize is a ≥2× downscale (VCR movie stills at
    ~1920px → 768/512 targets) — decode cost drops ~scale²; the follow-up
    bilinear resample then starts from the drafted image, which differs from
    a full-resolution resample by well under the resample's own kernel error.
    Pass ``draft=False`` for bit-parity with the reference loader
    (``box_utils.py:12-34``, full decode + one bilinear resize)."""
    Image = _pil_image()

    with Image.open(path) as im:
        w0, h0 = im.size
        scale = target / max(w0, h0)
        nw, nh = max(1, int(round(w0 * scale))), max(1, int(round(h0 * scale)))
        if draft:
            # no-op unless JPEG with ≥2× downscale (draft only does pow-2)
            im.draft("RGB", (nw, nh))
        pil = im.convert("RGB")
        if pil.size != (nw, nh):
            pil = pil.resize((nw, nh), Image.BILINEAR)
        raw = np.asarray(pil)
    img = normalize_image(raw) if normalize else raw
    h, w = img.shape[:2]
    if pad_square:
        out = np.zeros((target, target, 3), img.dtype)
        out[:h, :w] = img
        img = out
    return {
        "image": img,
        "scale": np.float32(scale),
        "height": np.int32(h),
        "width": np.int32(w),
    }


def image_wire_fields(img: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The batch fields a detector-path dataset emits for a store row:
    ``images`` in its wire dtype (uint8 when the store defers normalization
    to the device, fp32 otherwise) and ``image_hw`` — the true content
    extent inside the square padding, which the detector uses to re-zero
    the pad after in-graph normalization."""
    arr = np.asarray(img["image"])
    if arr.dtype != np.uint8:
        arr = np.asarray(arr, np.float32)
    return {
        "images": arr,
        "image_hw": np.asarray(
            [int(img.get("height", arr.shape[0])),
             int(img.get("width", arr.shape[1]))], np.int32
        ),
    }


class ImageFolderStore:
    """FeatureStore-compatible reader for the VCR raw-image path: each
    ``<image_id>.jpg`` plus a ``<image_id>.json`` metadata file holding
    {"boxes": [[x1,y1,x2,y2,...], ...], "names": [...], "segms": [...]} in
    ORIGINAL pixel coordinates (the VCR release layout)."""

    def __init__(self, folder: str, target: int = 768,
                 class_names: Optional[Sequence[str]] = None,
                 device_normalize: bool = True, draft: bool = True):
        """``device_normalize=True`` (default) ships uint8 over the wire —
        the detector normalizes in-graph and re-zeros the square padding
        from the per-image (height, width) it receives via ``image_hw``.
        False restores host-side fp32 normalization (4× the wire bytes)."""
        self.folder = folder
        self.target = target
        self.device_normalize = device_normalize
        self.draft = draft
        self.class_to_id = (
            {n: i for i, n in enumerate(class_names)} if class_names else None
        )

    def __contains__(self, image_id: str) -> bool:
        import os

        return os.path.exists(f"{self.folder}/{image_id}.jpg")

    def get(self, image_id: str) -> Dict[str, np.ndarray]:
        import json

        prep = prepare_image(
            f"{self.folder}/{image_id}.jpg", self.target,
            normalize=not self.device_normalize, draft=self.draft,
        )
        with open(f"{self.folder}/{image_id}.json") as f:
            meta = json.load(f)
        boxes = np.asarray(meta["boxes"], np.float32)[:, :4] * float(prep["scale"])
        names = meta.get("names", ["person"] * len(boxes))
        if self.class_to_id:
            classes = np.asarray([self.class_to_id.get(n, 0) for n in names], np.int32)
        else:
            classes = np.zeros(len(boxes), np.int32)
        out = {
            "image": prep["image"],
            "boxes": boxes,
            "classes": classes,
            # true content extent inside the square padding — the full-image
            # window box must cover this, not the padded canvas
            "height": prep["height"],
            "width": prep["width"],
        }
        if "segms" in meta:
            from visualbert_torch.utils.boxes import make_mask

            segms = []
            for polys, box in zip(meta["segms"], boxes):
                segms.append(make_mask([np.asarray(p) for p in polys], box))
            out["segms"] = np.stack(segms) if segms else np.zeros((0, 14, 14), np.float32)
        return out

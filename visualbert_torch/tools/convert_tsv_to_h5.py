"""Convert BUTD feature TSVs to the HDF5 layout ``H5Features`` reads.

Reference: ``unsupervised_visualbert/src/tools/convert_tsv_to_h5.py`` +
``src/utils.py:57-114`` (``load_obj_tsv_save_to_h5``). TSV columns:
img_id, img_h, img_w, objects_id, objects_conf, attrs_id, attrs_conf,
num_boxes, boxes, features — array columns base64-encoded.

The port's own copy of ``visualbert_tpu/tools/convert_tsv_to_h5.py``; its
files equal the JAX tool's. Needs h5py.

Usage: python -m visualbert_torch.tools.convert_tsv_to_h5 IN.tsv OUT.h5
"""

from __future__ import annotations

import base64
import csv
import json
import sys
from typing import Optional

import numpy as np

FIELDNAMES = [
    "img_id", "img_h", "img_w", "objects_id", "objects_conf",
    "attrs_id", "attrs_conf", "num_boxes", "boxes", "features",
]


def _decode(value: str, dtype, shape) -> np.ndarray:
    buf = base64.b64decode(value)
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def convert(tsv_path: str, h5_path: str, feat_dim: int = 2048,
            n_boxes: Optional[int] = None) -> int:
    import h5py

    rows = []
    csv.field_size_limit(sys.maxsize)
    with open(tsv_path) as f:
        for item in csv.DictReader(f, FIELDNAMES, delimiter="\t"):
            nb = int(item["num_boxes"])
            rows.append({
                "img_id": item["img_id"],
                "img_h": int(item["img_h"]),
                "img_w": int(item["img_w"]),
                "objects_id": _decode(item["objects_id"], np.int64, (nb,)),
                "objects_conf": _decode(item["objects_conf"], np.float32, (nb,)),
                "attrs_id": _decode(item["attrs_id"], np.int64, (nb,)),
                "attrs_conf": _decode(item["attrs_conf"], np.float32, (nb,)),
                "boxes": _decode(item["boxes"], np.float32, (nb, 4)),
                "features": _decode(item["features"], np.float32, (nb, feat_dim)),
            })
    if not rows:
        raise ValueError(f"empty tsv {tsv_path}")
    if n_boxes is None:
        n_boxes = max(r["features"].shape[0] for r in rows)

    n = len(rows)
    with h5py.File(h5_path, "w") as f:
        f.create_dataset("features", (n, n_boxes, feat_dim), dtype=np.float32)
        f.create_dataset("boxes", (n, n_boxes, 4), dtype=np.float32)
        f.create_dataset("objects_id", (n, n_boxes), dtype=np.int64)
        f.create_dataset("objects_conf", (n, n_boxes), dtype=np.float32)
        f.create_dataset("attrs_id", (n, n_boxes), dtype=np.int64)
        f.create_dataset("attrs_conf", (n, n_boxes), dtype=np.float32)
        f.create_dataset("img_h", (n,), dtype=np.int64)
        f.create_dataset("img_w", (n,), dtype=np.int64)
        for i, r in enumerate(rows):
            nb = min(r["features"].shape[0], n_boxes)
            f["features"][i, :nb] = r["features"][:nb]
            f["boxes"][i, :nb] = r["boxes"][:nb]
            f["objects_id"][i, :nb] = r["objects_id"][:nb]
            f["objects_conf"][i, :nb] = r["objects_conf"][:nb]
            f["attrs_id"][i, :nb] = r["attrs_id"][:nb]
            f["attrs_conf"][i, :nb] = r["attrs_conf"][:nb]
            f["img_h"][i] = r["img_h"]
            f["img_w"][i] = r["img_w"]

    ids = [r["img_id"] for r in rows]
    with open(h5_path.rsplit(".", 1)[0] + "_ids.json", "w") as f:
        json.dump(ids, f)
    return n


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__)
        return 1
    n = convert(argv[0], argv[1])
    print(f"wrote {n} images -> {argv[1]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""NLVR2 dataset (reference ``visualbert/dataloaders/nlvr_dataset.py``):
``NLVR2Dataset`` and ``make_synthetic`` of
``visualbert_tpu/data/datasets/nlvr2.py``, copied (importing the JAX
package pulls in JAX).

One example is a statement about a PAIR of images. The two images' region
features are concatenated along the region axis and told apart by
``visual_embeddings_type`` 0/1 (nlvr_dataset.py:98-114); the head is a
2-way classifier over the pooled output.

Annotations: [{"identifier": str, "sentence": str, "label": 0/1,
               "img0": str, "img1": str}] (the official jsonl rows with the
two image ids resolved).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from visualbert_torch.data.features import ChunkFeatures, FeatureStore, screen_features
from visualbert_torch.data.masking import assemble_pair
from visualbert_torch.data.pipeline import pad_regions
from visualbert_torch.data.tokenization import BertTokenizer


class NLVR2Dataset:
    def __init__(
        self,
        annotations: List[Dict],
        features: FeatureStore,
        tokenizer: BertTokenizer,
        *,
        max_seq_length: int = 128,
        max_regions_per_image: int = 72,  # the reference's image_feature_cap of 144 split across the pair
        screen_threshold: float = 0.2,
    ):
        self.annotations = annotations
        self.features = features
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.max_regions_per_image = max_regions_per_image
        # confidence screening when the store carries detector confidences
        # (the reference screens NLVR chunks, bert_data_utils.py:494-525)
        self.screen_threshold = screen_threshold

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, args) -> Dict[str, np.ndarray]:
        i, _ = args  # (index, rng): the example draws nothing at random
        item = self.annotations[i]
        tokens = self.tokenizer.tokenize(item["sentence"])[: self.max_seq_length - 2]
        enc = assemble_pair(tokens, None, self.tokenizer, self.max_seq_length)

        cap = self.max_regions_per_image
        visual, image_mask = [], []
        for key in ("img0", "img1"):
            r = self.features.get(str(item[key]))
            f, _ = screen_features(np.asarray(r["features"]), r.get("objects_conf"),
                                   threshold=self.screen_threshold, max_cap=cap)
            v, m = pad_regions(f, cap)
            visual.append(v)
            image_mask.append(m)

        sample = {
            "input_ids": enc.input_ids,
            "token_type_ids": enc.segment_ids,
            "input_mask": enc.input_mask,
            "visual_embeddings": np.concatenate(visual, axis=0),
            "image_mask": np.concatenate(image_mask, axis=0),
            "visual_embeddings_type": np.concatenate([np.zeros(cap, np.int32), np.ones(cap, np.int32)], axis=0),
            # the annotation's position, shipped inside the batch so the eval
            # dump recovers identifiers without depending on batch order
            "example_index": np.int32(i),
        }
        if item.get("label") is not None:
            sample["label"] = np.int32(item["label"])
        return sample


def make_synthetic(n: int, tokenizer: BertTokenizer, n_regions: int = 6, feat_dim: int = 32, seed: int = 0):
    """Small in-memory NLVR2 task for tests and smoke runs: the second
    image's features are shifted when the label is 1, so the label is
    learnable. Returns (annotations, ChunkFeatures)."""
    rng = np.random.default_rng(seed)
    words = [w for w in tokenizer.vocab if not w.startswith("[") and not w.startswith("##")]
    annotations, chunk = [], {}
    for i in range(n):
        label = int(rng.integers(2))
        chunk[f"{i}_0"] = {"features": rng.normal(size=(n_regions, feat_dim)).astype(np.float32)}
        chunk[f"{i}_1"] = {"features": (rng.normal(size=(n_regions, feat_dim)) + 3.0 * label).astype(np.float32)}
        annotations.append({"identifier": str(i), "sentence": " ".join(rng.choice(words, size=5)), "label": label,
                            "img0": f"{i}_0", "img1": f"{i}_1"})
    return annotations, ChunkFeatures(chunk)

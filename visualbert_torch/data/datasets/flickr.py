"""Flickr30k Entities grounding dataset (reference
``visualbert/dataloaders/flickr_dataset.py`` and ``flickr_ban/dataset.py``):
``subword_alignment``, ``Flickr30kDataset`` and ``make_synthetic`` of
``visualbert_tpu/data/datasets/flickr.py``, copied (importing the JAX
package pulls in JAX).

Each example is a caption whose entity phrases are linked to gold region
boxes. The ``flickr`` head gathers the hidden state at each entity's first
subword (``flickr_position``, +1 for ``[CLS]``), scores it against every
visual token and trains with KL-divergence against a distribution over the
gold regions (flickr_dataset.py:224-249; head modeling.py:1568-1598).

Annotations: [{"image_id": str, "words": [str, ...],
               "entities": [{"word_index": int, "region_targets": [int, ...]}]}]
(region_targets index into the image's region-feature rows).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from visualbert_torch.data.features import ChunkFeatures, FeatureStore
from visualbert_torch.data.masking import assemble_pair
from visualbert_torch.data.pipeline import pad_regions
from visualbert_torch.data.tokenization import BertTokenizer


def subword_alignment(words: List[str], tokenizer: BertTokenizer, max_tokens: int) -> Tuple[List[str], List[int]]:
    """Tokenize word by word; return (subwords, the first subword's index of
    each word, -1 for a word cut at ``max_tokens``), the reference's
    retokenize_with_alignment (vcr_data_utils.py:54-62)."""
    tokens: List[str] = []
    first_idx: List[int] = []
    for w in words:
        pieces = tokenizer.tokenize(w) or ["[UNK]"]
        if len(tokens) + len(pieces) > max_tokens:
            first_idx.append(-1)
            continue
        first_idx.append(len(tokens))
        tokens.extend(pieces)
    return tokens, first_idx


class Flickr30kDataset:
    def __init__(
        self,
        annotations: List[Dict],
        features: FeatureStore,
        tokenizer: BertTokenizer,
        *,
        max_seq_length: int = 128,
        max_regions: int = 100,
        max_entities: int = 16,
    ):
        self.annotations = annotations
        self.features = features
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.max_regions = max_regions
        self.max_entities = max_entities

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, args) -> Dict[str, np.ndarray]:
        i, _ = args  # (index, rng): the example draws nothing at random
        item = self.annotations[i]
        tokens, first_idx = subword_alignment(item["words"], self.tokenizer, self.max_seq_length - 2)
        enc = assemble_pair(tokens, None, self.tokenizer, self.max_seq_length)

        feat = self.features.get(str(item["image_id"]))["features"]
        visual, image_mask = pad_regions(feat, self.max_regions)

        E = self.max_entities
        positions = np.full(E, -1, np.int32)
        label = np.zeros((E, self.max_regions), np.float32)
        n_e = 0
        for ent in item["entities"]:
            if n_e >= E:
                break
            w = ent["word_index"]
            if w >= len(first_idx) or first_idx[w] < 0:
                continue
            # an entity whose gold boxes all lie beyond max_regions keeps its
            # slot with an all-zero label row (reference flickr_dataset.py:
            # 240-251), a sure miss; the mass is normalised over ALL its
            # targets, so targets cut away lower the reachable upper bound
            all_targets = ent["region_targets"]
            kept = [t for t in all_targets if t < self.max_regions]
            positions[n_e] = first_idx[w] + 1  # +1 for [CLS]
            if all_targets:
                label[n_e, kept] = 1.0 / len(all_targets)
            n_e += 1

        return {
            "input_ids": enc.input_ids,
            "token_type_ids": enc.segment_ids,
            "input_mask": enc.input_mask,
            "visual_embeddings": visual,
            "image_mask": image_mask,
            "flickr_position": positions,
            "label": label,
        }


def make_synthetic(n: int, tokenizer: BertTokenizer, n_regions: int = 8, feat_dim: int = 32, seed: int = 0):
    """Small in-memory grounding task for tests and smoke runs: each
    entity's word names its region (word ``words_pool[r]``, and region r
    carries a signature on channel r), so grounding is learnable. Returns
    (annotations, ChunkFeatures)."""
    rng = np.random.default_rng(seed)
    words_pool = [w for w in tokenizer.vocab if not w.startswith("[") and not w.startswith("##")]
    annotations, chunk = [], {}
    for i in range(n):
        words = list(rng.choice(words_pool, size=6))
        feats = rng.normal(size=(n_regions, feat_dim)).astype(np.float32)
        entities = []
        for j in range(2):
            r = int(rng.integers(n_regions))
            words[j] = words_pool[r]
            feats[r, r % feat_dim] += 5.0
            entities.append({"word_index": j, "region_targets": [r]})
        chunk[str(i)] = {"features": feats}
        annotations.append({"image_id": str(i), "words": words, "entities": entities})
    return annotations, ChunkFeatures(chunk)

"""VQA fine-tuning dataset of the unsupervised stack (counterpart of
``visualbert_tpu/data/datasets/unsup_vqa.py``; reference
``unsupervised_visualbert/src/tasks/vqa_data.py:114-252``): region features
and the detector's tags at inference (``tag_data_utilis.py:146-185``), the
question unmasked, soft-score targets over the task's answers (the model's
loss is BCE x num_answers). Examples are byte-identical to the JAX
package's.

Annotations: [{"question_id", "image_id", "sent", "label": {answer: score}}].
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from visualbert_torch.data.features import ChunkFeatures, FeatureStore, normalize_boxes
from visualbert_torch.data.masking import encode_single
from visualbert_torch.data.symbolic import SymbolicVocab
from visualbert_torch.data.tags import build_tags
from visualbert_torch.data.tokenization import BertTokenizer


class UnsupVQADataset:
    def __init__(self, annotations: List[Dict], features: FeatureStore, tokenizer: BertTokenizer,
                 symbolic_vocab: SymbolicVocab, answer_list: List[str], *, max_seq_length: int = 20,
                 n_regions: int = 36, insert_attr_ratio: float = 0.0):
        self.annotations = annotations
        self.features = features
        self.tokenizer = tokenizer
        self.symbolic_vocab = symbolic_vocab
        self.ans2id = {a: i for i, a in enumerate(answer_list)}
        self.num_answers = len(answer_list)
        self.max_seq_length = max_seq_length
        self.n_regions = n_regions
        self.insert_attr_ratio = insert_attr_ratio

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, args) -> Dict[str, np.ndarray]:
        i, rng = args if isinstance(args, tuple) else (args, np.random.default_rng(0))
        item = self.annotations[i]
        row = self.features.get(str(item["image_id"]))
        N = self.n_regions

        feats = np.asarray(row["features"], np.float32)[:N]
        boxes = normalize_boxes(np.asarray(row["boxes"], np.float32)[:N], float(row.get("img_h", 1.0)),
                                float(row.get("img_w", 1.0)))
        obj_ids = np.asarray(row.get("objects_id", np.zeros(N)), np.int64)[:N]
        attr_ids = np.asarray(row.get("attrs_id", np.zeros(N)), np.int64)[:N]
        tags, tag_boxes = build_tags(obj_ids, attr_ids, boxes, self.symbolic_vocab, rng, self.insert_attr_ratio)

        T = self.max_seq_length
        ids, mask, _ = encode_single(self.tokenizer, self.tokenizer.tokenize(item["sent"])[: T - 2], T)
        sample = {
            "input_ids": ids,
            "token_type_ids": np.zeros(T, np.int32),
            "input_mask": mask,
            "visual_feats": feats,
            "boxes": boxes,
            "visual_feats_mask": np.ones(N, np.int32),
            "visual_tags": tags.astype(np.int32),
            "visual_tags_box": tag_boxes,
            "visual_tags_mask": np.ones(N, np.int32),
            "question_id": np.int64(item.get("question_id", i)),
        }
        if "label" in item:
            target = np.zeros(self.num_answers, np.float32)
            for ans, score in item["label"].items():
                idx = self.ans2id.get(ans)
                if idx is not None:
                    target[idx] = score
            sample["target"] = target
        return sample


def make_synthetic(n: int, tokenizer: BertTokenizer, symbolic_vocab: SymbolicVocab, n_answers: int = 8,
                   n_regions: int = 6, feat_dim: int = 16, seed: int = 0):
    """(annotations, ChunkFeatures, answers) of ``n`` questions, the JAX
    package's set: the question repeats a word picked by its answer."""
    rng = np.random.default_rng(seed)
    words = [w for w in tokenizer.vocab if not w.startswith("[") and not w.startswith("##")]
    answers = [f"a{i}" for i in range(n_answers)]
    annotations, chunk = [], {}
    for i in range(n):
        a = int(rng.integers(n_answers))
        chunk[str(i)] = {
            "features": rng.normal(size=(n_regions, feat_dim)).astype(np.float32),
            "boxes": np.sort(np.abs(rng.normal(size=(n_regions, 4))), axis=-1).astype(np.float32),
            "objects_id": rng.integers(0, symbolic_vocab.n_obj, n_regions),
            "attrs_id": rng.integers(0, symbolic_vocab.n_attr, n_regions),
            "img_h": 5.0, "img_w": 5.0,
        }
        annotations.append({"question_id": i, "image_id": str(i), "sent": " ".join([words[a % len(words)]] * 3),
                            "label": {answers[a]: 1.0}})
    return annotations, ChunkFeatures(chunk), answers

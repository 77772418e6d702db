"""The VCR end-to-end model: the detector + VisualBERT (counterpart of
``visualbert_tpu/models/vcr.py``; reference ``VisualBERTDetector``,
``visualbert/models/model.py:23-189``).

``SimpleDetector`` runs once an image; its object representations are
broadcast across the answer choices (model.py:142-147), the encoder runs
with the ``multichoice`` head (or ``pretraining`` for choice-less COCO
batches), and the detector's auxiliary 81-way loss is added, scaled by
``cnn_loss_ratio`` (model.py:170-174, model_wrapper.py:70-73).

Batch keys: ``images`` [B, H, W, 3] (uint8 or fp32), ``image_hw`` [B, 2],
``boxes`` [B, N, 4], ``box_mask`` [B, N], ``classes`` [B, N], ``segms``
[B, N, 14, 14]; the text fields [B, C, T] (multichoice) or [B, T]
(pretraining), ``image_text_alignment`` [B, C, N, A] and ``label`` [B].
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models.detector import SimpleDetector
from visualbert_torch.models.visualbert import VisualBertForTask

_DETECTOR_KEYS = ("images", "boxes", "box_mask", "classes", "segms", "image_hw")


class VisualBertDetectorModel(nn.Module):
    """``detector`` (SimpleDetector) + ``bert`` (VisualBertForTask over
    ``final_dim``-wide visual embeddings). Forward takes a batch dict and an
    optional dropout generator (dropout on iff given), as
    ``VisualBertForTask`` does, so ``Trainer`` drives it unchanged."""

    def __init__(self, cfg: VisualBertConfig, head_type: str = "multichoice", final_dim: int = 512,
                 cnn_loss_ratio: float = 0.1, trunk_blocks=(3, 4, 6), layer4_blocks: int = 3, width_div: int = 1):
        super().__init__()
        self.cfg = cfg
        self.cnn_loss_ratio = cnn_loss_ratio
        self.detector = SimpleDetector(final_dim=final_dim, dtype=cfg.dtype, trunk_blocks=tuple(trunk_blocks),
                                       layer4_blocks=layer4_blocks, width_div=width_div)
        self.bert = VisualBertForTask(cfg.replace(visual_embedding_dim=final_dim), head_type)

    def init_weights(self, generator: torch.Generator) -> "VisualBertDetectorModel":
        self.detector.init_weights(generator)
        self.bert.init_weights(generator)
        return self

    def forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                output_attention_probs: bool = False):
        det = self.detector(batch["images"], batch["boxes"], batch["box_mask"], batch.get("classes"),
                            batch.get("segms"), generator, batch.get("image_hw"))
        obj_reps = det["obj_reps"]  # [B, N, final_dim]
        B, N, D = obj_reps.shape
        sub = {k: v for k, v in batch.items() if k not in _DETECTOR_KEYS}
        if batch["input_ids"].dim() == 2:
            # a choice-less batch (COCO pretraining): one text an image
            sub["visual_embeddings"], sub["image_mask"] = obj_reps, batch["box_mask"]
        else:
            C = batch["input_ids"].shape[1]
            # the image stream broadcast across the C choices (model.py:142-147)
            sub["visual_embeddings"] = obj_reps[:, None].expand(B, C, N, D)
            sub["image_mask"] = batch["box_mask"][:, None].expand(B, C, N)
        out = self.bert(sub, generator, output_attention_probs)
        cnn_loss = det.get("cnn_regularization_loss")
        out["cnn_regularization_loss"] = cnn_loss
        if out.get("loss") is not None and cnn_loss is not None:
            out["loss"] = out["loss"] + self.cnn_loss_ratio * cnn_loss
        return out

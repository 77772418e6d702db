"""Task-multiplexed VisualBERT objective (counterpart of
``visualbert_tpu/models/visualbert.py``; reference
``TrainVisualBERTObjective``, modeling.py:1335-1598).

This slice ports the pretraining branch (modeling.py:1400-1500, JAX
``visualbert.py:85-203``): MLM over the gathered ``mlm_positions`` plus the
sentence-image alignment loss. The other head types raise; ROADMAP.md A7
ports them.

Batch keys (tensors): ``input_ids``/``token_type_ids``/``input_mask`` [B, Tt],
``visual_embeddings`` [B, Tv, Dv], ``image_mask``/``visual_embeddings_type``
[B, Tv], ``image_text_alignment`` [B, Tv, A], ``masked_lm_labels`` [B, Tt]
(-1 unmasked), ``mlm_positions`` [B, P], ``is_random_next`` [B],
``example_weight`` [B]; [B, C, ...] choice stacks are flattened.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from visualbert_torch.config import HEAD_TYPES, VisualBertConfig
from visualbert_torch.models import losses
from visualbert_torch.models.encoder import VisualBertModel, init_weights
from visualbert_torch.models.heads import PreTrainingHeads


def _flatten_choices(x: Optional[torch.Tensor], extra_dims: int = 1) -> Optional[torch.Tensor]:
    """[B, C, ...] -> [B*C, ...] (reference modeling.py:1678-1696)."""
    if x is None or x.dim() == 1 + extra_dims:
        return x
    if x.dim() != 2 + extra_dims:
        raise ValueError(f"unexpected shape {tuple(x.shape)}")
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _drop_zero_weight_labels(labels, weights, ignore_index: int = -1):
    """Labels of zero-weight (tail-pad duplicate) examples become the ignore
    index, so the CE and accuracy reductions skip them."""
    if labels is None or weights is None:
        return labels
    w = weights
    if labels.shape[0] != w.shape[0]:
        w = w.repeat_interleave(labels.shape[0] // w.shape[0])
    keep = (w > 0).reshape((-1,) + (1,) * (labels.dim() - 1))
    return torch.where(keep, labels, torch.full_like(labels, ignore_index))


class VisualBertForTask(nn.Module):
    """``bert`` (VisualBertModel) + the head of ``head_type``. Forward takes
    a batch dict and an optional dropout generator (dropout on iff given)
    and returns a dict with ``loss`` and scalar metrics."""

    def __init__(self, cfg: VisualBertConfig, head_type: str):
        super().__init__()
        if head_type not in HEAD_TYPES:
            raise ValueError(f"unknown head_type {head_type}")
        if head_type != "pretraining":
            raise NotImplementedError(
                f"head_type {head_type!r} is not ported yet (ROADMAP.md A7: fine-tune heads)"
            )
        self.cfg = cfg
        self.head_type = head_type
        self.bert = VisualBertModel(cfg)
        self.cls = PreTrainingHeads(cfg)
        # the tied MLM decoder (reference modeling.py:411-414)
        self.cls.predictions.decoder.weight = self.bert.embeddings.word_embeddings.weight

    def init_weights(self, generator: torch.Generator) -> "VisualBertForTask":
        init_weights(self, self.cfg, generator)
        return self

    def forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None):
        input_ids = _flatten_choices(batch["input_ids"])
        token_type_ids = _flatten_choices(batch.get("token_type_ids"))
        input_mask = _flatten_choices(batch["input_mask"])
        image_mask = _flatten_choices(batch.get("image_mask"))
        visual_embeddings = _flatten_choices(batch.get("visual_embeddings"), extra_dims=2)
        visual_types = _flatten_choices(batch.get("visual_embeddings_type"))
        image_text_alignment = _flatten_choices(batch.get("image_text_alignment"), extra_dims=2)
        masked_lm_labels = _flatten_choices(batch.get("masked_lm_labels"))
        example_weight = batch.get("example_weight")
        masked_lm_labels = _drop_zero_weight_labels(masked_lm_labels, example_weight)

        if image_mask is not None:
            attention_mask = torch.cat([input_mask, image_mask], dim=-1)
            if masked_lm_labels is not None:
                # lm labels are -1 over the visual positions (modeling.py:1420-1426)
                pad = torch.full_like(image_mask, -1, dtype=masked_lm_labels.dtype)
                masked_lm_labels = torch.cat([masked_lm_labels, pad], dim=-1)
        else:
            attention_mask = input_mask
        if visual_types is None and image_mask is not None:
            visual_types = torch.zeros_like(image_mask, dtype=torch.long)

        sequence_output, pooled_output = self.bert(
            input_ids, token_type_ids, attention_mask, visual_embeddings, visual_types,
            image_text_alignment, generator,
        )

        out: Dict[str, torch.Tensor] = {}
        mlm_positions = batch.get("mlm_positions")
        if mlm_positions is not None:
            # decode only the <= P masked slots: the CE ignores every other
            # position, so the loss is the same at T/P less decoder work
            pos = _flatten_choices(mlm_positions).long()
            gathered = torch.gather(
                sequence_output, 1, pos[..., None].expand(-1, -1, sequence_output.shape[-1])
            )
            gathered_labels = None if masked_lm_labels is None else torch.gather(masked_lm_labels, 1, pos)
        else:
            gathered, gathered_labels = sequence_output, masked_lm_labels
        mlm_logits, nsp_logits = self.cls(gathered, pooled_output)
        out["logits"] = mlm_logits
        out["seq_relationship_score"] = nsp_logits

        total = torch.zeros((), device=mlm_logits.device)
        if gathered_labels is not None:
            valid = gathered_labels != -1
            mlm_loss = losses.cross_entropy_ignore_index(mlm_logits, gathered_labels)
            out["masked_lm_loss"] = mlm_loss
            total = total + mlm_loss
            correct = valid & (mlm_logits.argmax(dim=-1) == gathered_labels)
            out["mlm_accuracy"] = correct.sum() / valid.sum().clamp_min(1)
        if batch.get("is_random_next") is not None:
            nsp_loss = losses.cross_entropy_ignore_index(
                nsp_logits, _drop_zero_weight_labels(batch["is_random_next"].reshape(-1), example_weight)
            )
            out["next_sentence_loss"] = nsp_loss
            total = total + nsp_loss
        out["loss"] = total
        return out

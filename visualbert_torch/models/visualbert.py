"""Task-multiplexed VisualBERT objective (counterpart of
``visualbert_tpu/models/visualbert.py``; reference
``TrainVisualBERTObjective``, modeling.py:1335-1598).

The port has six branches:

* ``pretraining`` (modeling.py:1400-1500, JAX ``visualbert.py:85-203``): MLM
  over the gathered ``mlm_positions`` plus the sentence-image alignment
  loss, through the fused MLM cross-entropy when ``fused_mlm_xent`` is on
  (no ``logits`` in the output then);
* ``vqa_advanced`` (modeling.py:1527-1554, JAX ``visualbert.py:72-203``): VQA
  answer-as-MLM, the same tied head and MLM loss with no alignment loss;
  the fused cross-entropy takes the labels only in training (a dropout
  generator given), so evaluation returns the ``[B, P, V]`` logits that the
  answer dump decodes;
* ``vqa`` (modeling.py:1502-1521, JAX ``visualbert.py:217-232``): the
  classifier over the hidden state at ``sum(input_mask) - 2`` (the ``[MASK]``
  slot), KL-divergence batchmean against the soft ``label`` scores and the
  soft accuracy, both weighted by ``example_weight``;
* ``nlvr`` (JAX ``visualbert.py:80-81, 234-243``): a 2-way
  classifier over the pooled output, cross-entropy against the 0/1
  ``label`` and accuracy, both weighted by ``example_weight``;
* ``multichoice`` (VCR, JAX ``visualbert.py:75-76, 205-215``):
  a one-logit classifier over the pooled output of each flattened
  [B*C, T] row, reshaped to ``logits`` [B, C]; cross-entropy
  against the choice ``label`` and accuracy, both weighted by
  ``example_weight``;
* ``flickr`` (modeling.py:1568-1598, JAX ``visualbert.py:245-279``): entity
  grounding, ``FlickrAttention`` scores of the entity states at
  ``flickr_position`` over the visual tokens, KL-divergence batchmean
  against the [B, E, R] ``label`` distribution weighted by
  ``example_weight``, and the accuracy, reachable-mass upper bound and
  entity count over the real entities of real rows. It has no ``cls``: the
  Flax module declares one but never calls it, so it has no parameters.

With ``output_attention_probs`` the output also holds
``attention_weights``, the encoder's ``[L, B, H, T, T]`` fp32 probabilities.

Batch keys (tensors): ``input_ids``/``token_type_ids``/``input_mask`` [B, Tt],
``visual_embeddings`` [B, Tv, Dv], ``image_mask``/``visual_embeddings_type``
[B, Tv], ``image_text_alignment`` [B, Tv, A], ``masked_lm_labels`` [B, Tt]
(-1 unmasked), ``mlm_positions`` [B, P], ``is_random_next`` [B],
``example_weight`` [B], ``flickr_position`` [B, E] (-1 pad), ``label``
[B, num_answers] (vqa), [B] (nlvr, multichoice) or [B, E, Tv] (flickr);
[B, C, ...] choice stacks are flattened.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from visualbert_torch.config import HEAD_TYPES, VisualBertConfig
from visualbert_torch.models import losses
from visualbert_torch.models.encoder import VisualBertModel, init_weights
from visualbert_torch.models.heads import Classifier, FlickrAttention, PreTrainingHeads


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

    def __init__(self, cfg: VisualBertConfig, head_type: str, num_answers: int = 3129):
        super().__init__()
        if head_type not in HEAD_TYPES:
            raise ValueError(f"unknown head_type {head_type}")
        self.cfg = cfg
        self.head_type = head_type
        self.bert = VisualBertModel(cfg)
        if head_type in ("pretraining", "vqa_advanced"):
            self.cls = PreTrainingHeads(cfg)
            # the tied MLM decoder (reference modeling.py:411-414)
            self.cls.predictions.decoder.weight = self.bert.embeddings.word_embeddings.weight
        elif head_type == "flickr":
            self.flickr_attention = FlickrAttention(cfg)
        else:
            # the VQA classifier width (reference modeling.py:1362), NLVR2's two
            # classes, or one logit a VCR choice (modeling.py:1358)
            self.classifier = Classifier(cfg, {"vqa": num_answers, "nlvr": 2, "multichoice": 1}[head_type])

    def init_weights(self, generator: torch.Generator) -> "VisualBertForTask":
        init_weights(self, self.cfg, generator)
        return self

    def forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                output_attention_probs: bool = False):
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

        sequence_output, pooled_output, attn_probs = self.bert(
            input_ids, token_type_ids, attention_mask, visual_embeddings, visual_types,
            image_text_alignment, generator, output_attention_probs,
        )
        if self.head_type == "vqa":
            out = self._vqa(batch, input_mask, sequence_output, example_weight, generator)
        elif self.head_type in ("nlvr", "multichoice"):
            out = self._classify(batch, pooled_output, example_weight, generator)
        elif self.head_type == "flickr":
            out = self._flickr(batch, input_mask, image_mask, sequence_output, example_weight)
        else:
            out = self._mlm(batch, sequence_output, pooled_output, masked_lm_labels, example_weight,
                            training=generator is not None)
        if output_attention_probs:
            out["attention_weights"] = attn_probs
        return out

    def _mlm(self, batch, sequence_output, pooled_output, masked_lm_labels, example_weight, training):
        out: Dict[str, torch.Tensor] = {}
        pretraining = self.head_type == "pretraining"
        mlm_positions = batch.get("mlm_positions")
        if mlm_positions is not None:
            # decode only the <= P masked slots: the CE ignores every other
            # position, so the loss is the same at T/P less decoder work
            pos = _flatten_choices(mlm_positions).long()
            gathered = torch.gather(
                sequence_output, 1, pos[..., None].expand(-1, -1, sequence_output.shape[-1])
            )
            gathered_labels = None if masked_lm_labels is None else torch.gather(masked_lm_labels, 1, pos)
            # vqa_advanced's evaluation decodes answers from the logits, which
            # the fused path does not make (JAX visualbert.py:156-170)
            fuse = pretraining or training
        else:
            gathered, gathered_labels = sequence_output, masked_lm_labels
            fuse = pretraining
        mlm_logits, nsp_logits, mlm_nll, mlm_pred = self.cls(
            gathered, pooled_output, gathered_labels if fuse else None
        )
        if mlm_logits is not None:
            out["logits"] = mlm_logits
        out["seq_relationship_score"] = nsp_logits

        total = torch.zeros((), device=nsp_logits.device)
        if gathered_labels is not None:
            valid = gathered_labels != -1
            if mlm_nll is not None:
                # fused path: the same ignore_index=-1 mean over per-row nll
                zero = torch.zeros((), device=mlm_nll.device)
                mlm_loss = torch.where(valid, mlm_nll, zero).sum() / losses.denominator(valid.sum()).clamp_min(1)
                pred = mlm_pred
            else:
                mlm_loss = losses.cross_entropy_ignore_index(mlm_logits, gathered_labels)
                pred = mlm_logits.argmax(dim=-1)
            out["masked_lm_loss"] = mlm_loss
            total = total + mlm_loss
            correct = valid & (pred == gathered_labels)
            out["mlm_accuracy"] = correct.sum() / losses.denominator(valid.sum()).clamp_min(1)
        if pretraining and batch.get("is_random_next") is not None:
            nsp_loss = losses.cross_entropy_ignore_index(
                nsp_logits, _drop_zero_weight_labels(batch["is_random_next"].reshape(-1), example_weight)
            )
            out["next_sentence_loss"] = nsp_loss
            total = total + nsp_loss
        out["loss"] = total
        return out

    def _vqa(self, batch, input_mask, sequence_output, example_weight, generator):
        # pool at sum(input_mask) - 2, the [MASK] slot before the final [SEP]
        # (reference modeling.py:1502-1515)
        idx = (input_mask.sum(dim=1) - 2).long()
        pooled = torch.gather(sequence_output, 1, idx[:, None, None].expand(-1, 1, sequence_output.shape[-1]))[:, 0]
        logits = self.classifier(pooled, generator)
        out: Dict[str, torch.Tensor] = {"logits": logits}
        label = batch.get("label")
        if label is not None:
            out["loss"] = losses.kl_div_batchmean(torch.log_softmax(logits, dim=-1), label, example_weight)
            out["accuracy"] = losses.weighted_mean(losses.vqa_accuracy_scores(logits, label), example_weight)
        return out

    def _classify(self, batch, pooled_output, example_weight, generator):
        """nlvr's two logits a row, or multichoice's one logit a [B*C] choice
        row reshaped to the batch's [B, C]; CE against ``label`` and accuracy."""
        logits = self.classifier(pooled_output, generator)
        if self.head_type == "multichoice":
            logits = logits.reshape(batch["input_ids"].shape[:2])
        out: Dict[str, torch.Tensor] = {"logits": logits}
        label = batch.get("label")
        if label is not None:
            out["loss"] = losses.cross_entropy(logits, label, example_weight)
            out["accuracy"] = losses.weighted_mean(logits.argmax(dim=-1) == label, example_weight)
        return out

    def _flickr(self, batch, input_mask, image_mask, sequence_output, example_weight):
        flickr_position = batch.get("flickr_position")
        if flickr_position is None:
            return {}
        pos_mask = flickr_position != -1
        if example_weight is not None:
            # tail-pad duplicate rows contribute no entities
            pos_mask = pos_mask & (example_weight > 0)[:, None]
        # the entities' hidden states (reference modeling.py:1573-1581)
        safe = flickr_position.clamp_min(0).long()
        selected = torch.gather(sequence_output, 1, safe[..., None].expand(-1, -1, sequence_output.shape[-1]))
        scores = self.flickr_attention(selected, sequence_output[:, input_mask.shape[1]:], image_mask)
        label = batch["label"].float()
        out: Dict[str, torch.Tensor] = {
            "logits": scores,
            "loss": losses.kl_div_batchmean(torch.log_softmax(scores, dim=-1), label, example_weight),
        }
        # a hit: the argmax region carries gold mass (reference modeling.py:1648-1676)
        hit = torch.gather(label, 2, scores.argmax(dim=-1, keepdim=True))[..., 0] > 0
        n_entities = losses.denominator(pos_mask.sum()).clamp_min(1)
        out["accuracy"] = (hit & pos_mask).sum() / n_entities
        # the gold mass within the kept regions caps the accuracy (upper_bound_labels, :1595-1596, 1652)
        out["upperbound_accuracy"] = torch.where(pos_mask, label.sum(dim=-1), 0.0).sum() / n_entities
        out["entity_num"] = pos_mask.sum()
        return out

"""Pretraining and classifier heads (counterpart of
``visualbert_tpu/models/heads.py``; reference modeling.py:389-452,
1355-1366).

``PreTrainingHeads`` is HF's ``cls``: ``predictions`` (the MLM transform,
the decoder whose weight IS ``bert.embeddings.word_embeddings.weight``, and
the output bias) and ``seq_relationship`` (the sentence-image alignment
classifier). With ``fused_mlm_xent`` and labels given, the MLM branch runs
the fused softmax cross-entropy (``ops/mlm_xent.py``, kernels K4-K6) and
returns per-row nll and argmax, no logits (JAX ``heads.py:86-102``);
otherwise the decoder runs the unfused path (``heads.py:104-113``):
compute-dtype operands, fp32 accumulation and fp32 logits.

``FlickrAttention`` is the ``flickr`` head's entity-to-region scorer (JAX
``heads.py:117-141``, reference modeling.py:1602-1646).

``Classifier`` is the VQA head's ``classifier`` (JAX ``heads.py:144-163``):
dropout, a dense layer in the compute dtype, fp32 logits.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models.encoder import NEG_INF, linear, matmul_f32_out, seeded_dropout
from visualbert_torch.ops.layer_norm import layer_norm_f32
from visualbert_torch.ops.mlm_xent import mlm_xent, supports_mesh


class MLMTransform(nn.Module):
    """dense -> gelu -> LayerNorm (reference modeling.py:389-401)."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, hidden):
        cfg = self.cfg
        x = F.gelu(linear(hidden, self.dense, cfg.dtype))
        return layer_norm_f32(x, self.LayerNorm.weight, self.LayerNorm.bias, cfg.layer_norm_eps).to(cfg.dtype)


class LMPredictionHead(nn.Module):
    """MLM transform + tied decoder + output bias (HF ``cls.predictions``),
    over ``vocab_size`` entries (default the word vocabulary).
    ``decoder.weight`` is replaced by the embedding table's Parameter by the
    owning model, so the tie cannot drift."""

    def __init__(self, cfg: VisualBertConfig, vocab_size: Optional[int] = None):
        super().__init__()
        vocab_size = cfg.vocab_size if vocab_size is None else vocab_size
        self.transform = MLMTransform(cfg)
        self.decoder = nn.Linear(cfg.hidden_size, vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, hidden):
        x = self.transform(hidden)
        return matmul_f32_out(x, self.decoder.weight) + self.bias.float()


class PreTrainingHeads(nn.Module):
    """MLM + sentence-image alignment heads (reference modeling.py:404-452).
    Returns ``(mlm_logits, nsp_logits, mlm_nll, mlm_argmax)``: fp32 logits
    and ``None, None`` on the unfused path; ``None`` logits and the fused
    op's per-position nll and argmax (shaped like ``labels``) when
    ``fused_mlm_xent`` is on and ``labels`` are given. Under a mesh whose
    model axis splits the rows, the fused op splits them there (JAX
    ``heads.py:86-101``); otherwise the unfused decoder runs."""

    mesh = None

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        self.predictions = LMPredictionHead(cfg)
        self.seq_relationship = nn.Linear(cfg.hidden_size, 2)

    def forward(self, sequence_output, pooled_output, labels=None):
        cfg = self.cfg
        nsp = linear(pooled_output, self.seq_relationship, cfg.dtype).float()
        if cfg.fused_mlm_xent and labels is not None and supports_mesh(labels.numel(), self.mesh):
            pred = self.predictions
            x = pred.transform(sequence_output)
            # the tied decoder weight enters in the compute dtype; autograd
            # carries d embedding through the cast into the fp32 Parameter
            nll, am = mlm_xent(x.reshape(-1, x.shape[-1]), pred.decoder.weight.to(cfg.dtype), pred.bias,
                               labels.reshape(-1), mesh=self.mesh)
            return None, nsp, nll.view(labels.shape), am.view(labels.shape)
        return self.predictions(sequence_output), nsp, None, None


class FlickrAttention(nn.Module):
    """One-head scaled QK attention of entity states over the visual
    tokens: ``query`` and ``key`` dense layers in the compute dtype, scores
    summed in fp32 from their compute-dtype products (JAX
    ``preferred_element_type=jnp.float32``), scaled by ``sqrt(hidden /
    num_heads)`` although one head attends (the reference's quirk), padded
    regions at -10000. Returns [B, E, R] fp32."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, entity_states, visual_states, image_mask):
        cfg = self.cfg
        q = linear(entity_states, self.query, cfg.dtype)  # [B, E, H]
        k = linear(visual_states, self.key, cfg.dtype)    # [B, R, H]
        # products of compute-dtype values are exact in fp32: this is the
        # mixed-precision product, its output never rounded to cfg.dtype
        scores = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(cfg.head_dim)
        return scores + ((1.0 - image_mask.float()) * NEG_INF)[:, None, :]


class Classifier(nn.Linear):
    """Dropout + linear classifier over a pooled state (JAX ``Classifier``,
    whose dropout is a stock ``nn.Dropout``: :func:`seeded_dropout` here,
    never the K3 kernel). A ``nn.Linear`` itself, so its parameters carry
    the HF names ``classifier.weight`` / ``classifier.bias``."""

    mesh = None

    def __init__(self, cfg: VisualBertConfig, num_classes: int):
        super().__init__(cfg.hidden_size, num_classes)
        self.cfg = cfg

    def forward(self, pooled, generator=None):
        x = seeded_dropout(pooled, self.cfg.hidden_dropout_prob, generator, self.mesh)
        return linear(x, self, self.cfg.dtype).float()

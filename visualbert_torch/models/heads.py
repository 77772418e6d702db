"""Pretraining heads (counterpart of ``visualbert_tpu/models/heads.py``;
reference modeling.py:389-452).

``PreTrainingHeads`` is HF's ``cls``: ``predictions`` (the MLM transform,
the decoder whose weight IS ``bert.embeddings.word_embeddings.weight``, and
the output bias) and ``seq_relationship`` (the sentence-image alignment
classifier). The decoder runs the unfused path of the JAX package
(``heads.py:104-113``): compute-dtype operands, fp32 accumulation and fp32
logits. The fused cross-entropy kernels (K4-K6) are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models.encoder import linear
from visualbert_torch.ops.layer_norm import layer_norm_f32


class _MatmulF32Out(torch.autograd.Function):
    """``x @ w.T`` for 2-D half-precision ``x`` and ``w`` on a CUDA device,
    accumulated and returned in fp32 (JAX's ``preferred_element_type``).
    The backward rounds the fp32 cotangent to the operands' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g16 = g.to(x.dtype)
        return torch.mm(g16, w), torch.mm(g16.t(), x, out_dtype=torch.float32).to(w.dtype)


def matmul_f32_out(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., E] x [V, E] -> [..., V] fp32, operands in ``x.dtype``."""
    w = w.to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
        out = _MatmulF32Out.apply(x2, w)
    else:
        # products of half-precision values are exact in fp32, so this is
        # the same math on a device without a mixed-precision product
        out = torch.mm(x2.float(), w.float().t())
    return out.view(*x.shape[:-1], w.shape[0])


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
    """MLM transform + tied decoder + output bias (HF ``cls.predictions``).
    ``decoder.weight`` is replaced by the word-embedding Parameter by the
    owning model, so the tie cannot drift."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.transform = MLMTransform(cfg)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, hidden):
        x = self.transform(hidden)
        return matmul_f32_out(x, self.decoder.weight) + self.bias.float()


class PreTrainingHeads(nn.Module):
    """MLM + sentence-image alignment heads (reference modeling.py:404-452).
    Returns ``(mlm_logits, nsp_logits)``, both fp32."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        self.predictions = LMPredictionHead(cfg)
        self.seq_relationship = nn.Linear(cfg.hidden_size, 2)

    def forward(self, sequence_output, pooled_output):
        nsp = linear(pooled_output, self.seq_relationship, self.cfg.dtype).float()
        return self.predictions(sequence_output), nsp

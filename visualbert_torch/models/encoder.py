"""VisualBERT encoder in PyTorch (counterpart of ``visualbert_tpu/models/encoder.py``).

Semantics are the reference single-stream model's
(``visualbert/pytorch_pretrained_bert/modeling.py``): joint text + visual
embeddings under one LayerNorm (modeling.py:1198-1257), post-LN layers
(:322-371), additive ``(1 - m) * -10000`` mask (:1286-1294), tanh pooler
(:374-386). Module and parameter names are the reference/HF torch names that
``visualbert_tpu/tools/export_torch.py::export_state_dict`` emits, so a Flax
checkpoint loads with ``load_state_dict(strict=True)``.

Precision follows ``cfg.dtype`` explicitly, as the JAX code does (no
autocast): parameters stay in ``cfg.param_dtype`` and are cast at use;
LayerNorm statistics, attention scores and softmax are fp32; probabilities
are cast to the compute dtype before PV.

Dropout is on exactly when a ``torch.Generator`` is passed down: each
dropout site draws its own int32 seed from it. With ``cfg.fast_dropout`` the
hidden-state sites use the K3 mask kernel (``ops/dropout.py``); otherwise,
and for attention probabilities on the einsum path, ``F.dropout`` (torch's
own generator) as the JAX package uses ``nn.Dropout``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from visualbert_torch.config import VisualBertConfig
from visualbert_torch.ops.dropout import fast_dropout
from visualbert_torch.ops.flash_attention import flash_attention_packed
from visualbert_torch.ops.layer_norm import layer_norm_f32, reference_add_layer_norm

NEG_INF = -10000.0  # reference mask value (modeling.py:1294), not -inf
_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] {0,1} mask -> additive [B, 1, 1, T] fp32 bias, -10000 at pads."""
    return ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]


def draw_seed(generator: torch.Generator) -> int:
    """One int32 dropout seed per site and step."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            cfg: VisualBertConfig) -> torch.Tensor:
    if generator is None or rate <= 0.0:
        return x
    if cfg.fast_dropout:
        return fast_dropout(x, rate, draw_seed(generator))
    return F.dropout(x, rate, training=True)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``nn.Dense(dtype=dtype)``: weight and bias cast to the compute dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def init_weights(module: nn.Module, cfg: VisualBertConfig, generator: torch.Generator) -> None:
    """Flax-matching init: truncated normal (std ``initializer_range``,
    truncated at 2 std) for matrices and tables, zero biases, unit LN scales.
    Modules are visited in registration order, so a seed fixes the weights."""
    std = cfg.initializer_range / _TRUNC_STD
    seen = set()
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                if id(m.weight) not in seen:
                    seen.add(id(m.weight))
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                if isinstance(m, nn.Linear) and m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class FusedQKV(nn.Module):
    """The Q, K and V projections (HF ``attention.self``), kept as three
    weights and assembled at call time into one product: head-major packed
    ``[B, T, H*3*D]`` with the bias returned separately (deferred into the
    attention kernel), or ``[B, T, 3, H, D]`` with the bias added."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.num_attention_heads * cfg.head_dim
        self.query = nn.Linear(cfg.hidden_size, hd)
        self.key = nn.Linear(cfg.hidden_size, hd)
        self.value = nn.Linear(cfg.hidden_size, hd)

    def forward(self, hidden: torch.Tensor, packed: bool):
        cfg = self.cfg
        E, H, D = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
        w = torch.stack([self.query.weight, self.key.weight, self.value.weight]).to(cfg.dtype)
        b = torch.stack([self.query.bias, self.key.bias, self.value.bias]).to(cfg.dtype)
        if packed:
            # [3, H*D, E] -> [E, H, 3, D]: head-major [h, (q,k,v), d]
            wp = w.view(3, H, D, E).permute(3, 1, 0, 2).reshape(E, 3 * H * D)
            bp = b.view(3, H, D).permute(1, 0, 2).reshape(3 * H * D)
            return torch.matmul(hidden, wp), bp
        out = torch.matmul(hidden, w.reshape(3 * H * D, E).t()) + b.reshape(-1)
        return out.view(*hidden.shape[:-1], 3, H, D)


class ResidualNorm(nn.Module):
    """``LayerNorm(dropout(dense(x)) + residual)``, the sublayer epilogue
    (reference modeling.py:271-276/312-318; HF ``BertSelfOutput``/``BertOutput``).
    Its ``dense`` is the attention's output projection (JAX ``OutProj``,
    which in the packed layout is a plain [H*D, E] product) or the FFN's
    down projection."""

    def __init__(self, cfg: VisualBertConfig, in_features: int):
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(in_features, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, res, generator=None):
        cfg = self.cfg
        x = linear(x, self.dense, cfg.dtype)
        x = dropout(x, cfg.hidden_dropout_prob, generator, cfg)
        return reference_add_layer_norm(x, res, self.LayerNorm.weight, self.LayerNorm.bias, cfg.layer_norm_eps)


class SelfAttention(nn.Module):
    """Multi-head self-attention plus its epilogue (reference
    modeling.py:207-276; HF ``attention`` = ``self`` + ``output``). With
    ``use_flash_attention`` it runs the packed kernels K1/K2; otherwise the
    einsum path with fp32 scores (JAX ``encoder.py:292-305``)."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        self.self = FusedQKV(cfg)
        self.output = ResidualNorm(cfg, cfg.num_attention_heads * cfg.head_dim)

    def forward(self, hidden, attn_bias, generator=None):
        cfg = self.cfg
        H, D = cfg.num_attention_heads, cfg.head_dim
        rate = cfg.attention_probs_dropout_prob if generator is not None else 0.0
        if cfg.use_flash_attention:
            qkv, qkv_bias = self.self(hidden, packed=True)
            seed = draw_seed(generator) if rate > 0.0 else None
            ctx = flash_attention_packed(qkv, H, attn_bias, rate, seed, qkv_bias=qkv_bias)
        else:
            qkv = self.self(hidden, packed=False)
            q, k, v = qkv.unbind(dim=2)  # [B, T, H, D]
            scale = 1.0 / math.sqrt(D)
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            scores = scores * scale + attn_bias.float()
            probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
            if rate > 0.0:
                probs = F.dropout(probs, rate, training=True)
            ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(*hidden.shape[:-1], H * D)
        return self.output(ctx, hidden, generator)


class Intermediate(nn.Module):
    """FFN up projection and exact-erf GELU (reference modeling.py:295-305)."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        if cfg.hidden_act != "gelu":
            raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}: the port has the exact-erf gelu")
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, hidden):
        return F.gelu(linear(hidden, self.dense, self.cfg.dtype))


class TransformerLayer(nn.Module):
    """Post-LN BERT layer: attention -> add&norm -> FFN -> add&norm."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.intermediate = Intermediate(cfg)
        self.output = ResidualNorm(cfg, cfg.intermediate_size)

    def forward(self, hidden, attn_bias, generator=None):
        hidden = self.attention(hidden, attn_bias, generator)
        return self.output(self.intermediate(hidden), hidden, generator)


class TransformerEncoder(nn.Module):
    """The layer stack, a plain list (reference modeling.py:344-371)."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.layer = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden, attn_bias, generator=None):
        for layer in self.layer:
            hidden = layer(hidden, attn_bias, generator)
        return hidden


class VisualBertEmbeddings(nn.Module):
    """Joint text + visual embeddings (reference modeling.py:1169-1257).

    Visual tokens: projected region features + visual token type + a
    constant position row (index 0 of the visual table), plus, when
    ``image_text_alignment`` [B, Tv, A] (-1 pad) is given, the mean of the
    aligned words' text position embeddings (modeling.py:1223-1245)."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        E = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, E)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, E)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, E)
        self.token_type_embeddings_visual = nn.Embedding(cfg.type_vocab_size, E)
        self.position_embeddings_visual = nn.Embedding(cfg.max_position_embeddings, E)
        self.projection = nn.Linear(cfg.visual_embedding_dim, E)
        self.LayerNorm = nn.LayerNorm(E, eps=cfg.layer_norm_eps)

    def _embed(self, table: nn.Embedding, idx: torch.Tensor) -> torch.Tensor:
        return F.embedding(idx, table.weight).to(self.cfg.dtype)

    def forward(self, input_ids, token_type_ids=None, visual_embeddings=None,
                visual_token_type_ids=None, image_text_alignment=None, generator=None):
        cfg = self.cfg
        B, Tt = input_ids.shape
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        positions = torch.arange(Tt, device=input_ids.device)[None, :]
        text = (self._embed(self.word_embeddings, input_ids)
                + self._embed(self.position_embeddings, positions)
                + self._embed(self.token_type_embeddings, token_type_ids))
        if visual_embeddings is not None:
            Tv = visual_embeddings.shape[1]
            vis = linear(visual_embeddings, self.projection, cfg.dtype)
            if visual_token_type_ids is None:
                visual_token_type_ids = torch.zeros((B, Tv), dtype=torch.long, device=input_ids.device)
            vis = vis + self._embed(self.token_type_embeddings_visual, visual_token_type_ids)
            vis_pos0 = self._embed(self.position_embeddings_visual, torch.zeros_like(visual_token_type_ids))
            if image_text_alignment is not None:
                align_mask = (image_text_alignment != -1).float()
                pos = self._embed(self.position_embeddings, image_text_alignment.clamp_min(0))
                pos = pos.float() * align_mask[..., None]
                denom = align_mask.sum(dim=2).clamp_min(1.0)
                aligned = pos.sum(dim=2) / denom[..., None]
                vis = vis + aligned.to(cfg.dtype) + vis_pos0
            else:
                vis = vis + vis_pos0
            text = torch.cat([text, vis], dim=1)
        out = layer_norm_f32(text, self.LayerNorm.weight, self.LayerNorm.bias, cfg.layer_norm_eps).to(cfg.dtype)
        return dropout(out, cfg.hidden_dropout_prob, generator, cfg)


class Pooler(nn.Module):
    """tanh(dense(first token)) (reference modeling.py:374-386)."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, hidden):
        return torch.tanh(linear(hidden[:, 0], self.dense, self.cfg.dtype))


class VisualBertModel(nn.Module):
    """Embeddings + encoder + pooler (reference ``BertVisualModel``,
    modeling.py:1260-1333), with the ``bypass_transformer`` split path: text
    through the whole stack alone, then one joint layer (:1299-1314).
    Returns ``(sequence_output, pooled_output)``."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        cfg.check_ported()
        self.cfg = cfg
        self.embeddings = VisualBertEmbeddings(cfg)
        self.encoder = TransformerEncoder(cfg)
        self.pooler = Pooler(cfg)
        if cfg.bypass_transformer:
            self.additional_layer = TransformerLayer(cfg)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None, visual_embeddings=None,
                visual_token_type_ids=None, image_text_alignment=None, generator=None):
        B, Tt = input_ids.shape
        Tv = 0 if visual_embeddings is None else visual_embeddings.shape[1]
        if attention_mask is None:
            attention_mask = torch.ones((B, Tt + Tv), dtype=torch.long, device=input_ids.device)
        hidden = self.embeddings(input_ids, token_type_ids, visual_embeddings, visual_token_type_ids,
                                 image_text_alignment, generator)
        attn_bias = mask_to_bias(attention_mask)
        if self.cfg.bypass_transformer and visual_embeddings is not None:
            text_out = self.encoder(hidden[:, :Tt], attn_bias[..., :Tt], generator)
            joint = torch.cat([text_out, hidden[:, Tt:]], dim=1)
            seq_out = self.additional_layer(joint, attn_bias, generator)
        else:
            seq_out = self.encoder(hidden, attn_bias, generator)
        return seq_out, self.pooler(seq_out)

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

Attention probabilities are collected (JAX ``encoder.py:258, 465``) when
the caller asks (``output_attention_probs``) or ``cfg.output_attention_weights``
is set: each layer then takes the einsum path, whatever
``use_flash_attention`` says, and hands back its fp32 softmax before the
cast and the dropout; the encoder stacks them to ``[L, B, H, T, T]``.

Dropout is on exactly when a ``torch.Generator`` is passed down: each
dropout site draws its own int32 seed from it. With ``cfg.fast_dropout`` the
hidden-state sites run the dropout site kernels on K3's Philox body
(``ops/dropout.py::fast_dropout``: one kernel forward, one backward from
the saved keep bits); otherwise,
and for attention probabilities on the einsum path, :func:`seeded_dropout`
(the JAX package's ``nn.Dropout``), whose mask comes from a generator on the
tensor's device seeded from that int32, so a run repeats from its seed. With
``cfg.use_fused_layer_norm`` the sublayer epilogue's dropout, add and
LayerNorm run as one kernel (K9/K10, or K7/K8 without dropout).

Tensor parallel (``parallel/mesh.py``; Megatron's column/row split): under
a mesh whose model axis is m > 1, ``shard_module`` leaves each layer with
its model rank's block of the Q/K/V rows (whole heads of the head-major
packing, ``H / m`` of them) and of the FFN's up-projection rows, and the
matching input columns of the attention output and FFN down projections.
The input of each column-parallel product goes through ``copy_to_model``
(identity forward, all-reduce backward); each row-parallel product's
partial sums, fp32, go through ``reduce_from_model`` (one all-reduce)
before the bias, the dropout, the add and the LayerNorm, which run on the
replicated hidden state. The attention kernels run on the local heads with
their seed offset by the data and model index; the hidden-state dropout
sites (K3's body, K9) take a seed offset by the data index only, so model
peers keep equal replicas. Collected attention probabilities are gathered
over the heads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from visualbert_torch.config import VisualBertConfig
from visualbert_torch.ops.dropout import fast_dropout
from visualbert_torch.ops.flash_attention import flash_attention_heads_major, flash_attention_packed
from visualbert_torch.ops.layer_norm import (
    fused_add_layer_norm,
    fused_dropout_add_layer_norm,
    layer_norm_f32,
    reference_add_layer_norm,
)
from visualbert_torch.parallel.mesh import copy_to_model, gather_slices, reduce_from_model

NEG_INF = -10000.0  # reference mask value (modeling.py:1294), not -inf
_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


def mask_to_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, T] {0,1} mask -> additive [B, 1, 1, T] fp32 bias, -10000 at pads."""
    return ((1.0 - mask.float()) * NEG_INF)[:, None, None, :]


def draw_seed(generator: torch.Generator) -> int:
    """One int32 dropout seed per site and step."""
    return int(torch.randint(0, 2**31 - 1, (), generator=generator))


def seeded_dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], mesh=None,
                   per_model: bool = False) -> torch.Tensor:
    """``nn.Dropout``: ``where(keep, x / (1 - rate), 0)``, the keep mask drawn
    from a generator on ``x``'s device seeded by ``draw_seed(generator)``,
    offset under a ``mesh`` by the data index (and by the model index too
    with ``per_model``, for a tensor split over the model group)."""
    if generator is None or rate <= 0.0:
        return x
    seed = draw_seed(generator)
    if mesh is not None:
        seed = mesh.shard_seed(seed) if per_model else mesh.data_seed(seed)
    g = torch.Generator(device=x.device).manual_seed(seed)
    keep = torch.rand(x.shape, generator=g, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            cfg: VisualBertConfig, mesh=None) -> torch.Tensor:
    """A hidden-state dropout site: the site kernels with ``cfg.fast_dropout``,
    else :func:`seeded_dropout`; one mask across the model group."""
    if generator is None or rate <= 0.0:
        return x
    if cfg.fast_dropout:
        seed = draw_seed(generator)
        return fast_dropout(x, rate, seed) if mesh is None else fast_dropout(x, rate, seed, mesh=mesh)
    return seeded_dropout(x, rate, generator, mesh)


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``nn.Dense(dtype=dtype)``: weight and bias cast to the compute dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


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
    weights and assembled at call time into one product, in the layout
    ``layout`` names (JAX ``FusedQKV``): ``"packed"``, head-major packed
    ``[B, T, H*3*D]`` with the bias returned separately (deferred into the
    attention kernel); ``"heads_major"``, ``[B, 3, H, T, D]`` with the bias
    added (JAX ``einsum("bte,eshd->bshtd")``; the relayout is a copy of the
    product); ``"split"``, ``[B, T, 3, H, D]`` with the bias added."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.num_attention_heads * cfg.head_dim
        self.query = nn.Linear(cfg.hidden_size, hd)
        self.key = nn.Linear(cfg.hidden_size, hd)
        self.value = nn.Linear(cfg.hidden_size, hd)

    def forward(self, hidden: torch.Tensor, layout: str):
        cfg = self.cfg
        E, D = cfg.hidden_size, cfg.head_dim
        H = self.query.weight.shape[0] // D  # this model rank's heads
        w = torch.stack([self.query.weight, self.key.weight, self.value.weight]).to(cfg.dtype)
        b = torch.stack([self.query.bias, self.key.bias, self.value.bias]).to(cfg.dtype)
        if layout == "packed":
            # [3, H*D, E] -> [E, H, 3, D]: head-major [h, (q,k,v), d]
            wp = w.view(3, H, D, E).permute(3, 1, 0, 2).reshape(E, 3 * H * D)
            bp = b.view(3, H, D).permute(1, 0, 2).reshape(3 * H * D)
            return torch.matmul(hidden, wp), bp
        out = (torch.matmul(hidden, w.reshape(3 * H * D, E).t()) + b.reshape(-1)).view(*hidden.shape[:-1], 3, H, D)
        if layout == "heads_major":
            return out.permute(0, 2, 3, 1, 4).contiguous()
        return out


class ResidualNorm(nn.Module):
    """``LayerNorm(dropout(dense(x)) + residual)``, the sublayer epilogue
    (reference modeling.py:271-276/312-318; HF ``BertSelfOutput``/``BertOutput``).
    Its ``dense`` is the attention's output projection (JAX ``OutProj``:
    a plain [H*D, E] product of the packed or split context, the einsum
    ``"bhtd,hde->bte"`` of a heads-major [B, H, T, D] one) or the FFN's down
    projection. With ``use_fused_layer_norm`` the rest is one kernel,
    dispatched as JAX ``encoder.py:339-354``: K9/K10 with dropout on, K7/K8
    without (evaluation, or a rate of 0). Under tensor parallelism
    ``dense`` is row-parallel (see the module docstring)."""

    mesh = None

    def __init__(self, cfg: VisualBertConfig, in_features: int):
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(in_features, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, res, generator=None, heads_major: bool = False):
        cfg = self.cfg
        if self.mesh is not None and self.mesh.model_size > 1:
            if heads_major:  # [B, H/m, T, D] -> [B, T, H/m * D]
                x = x.permute(0, 2, 1, 3).reshape(x.shape[0], x.shape[2], -1)
            partial = matmul_f32_out(x.to(cfg.dtype), self.dense.weight)
            x = (reduce_from_model(partial, self.mesh) + self.dense.bias.float()).to(cfg.dtype)
        elif heads_major:
            H, D = x.shape[1], x.shape[3]
            w = self.dense.weight.to(cfg.dtype).view(cfg.hidden_size, H, D)
            x = torch.einsum("bhtd,ehd->bte", x.to(cfg.dtype), w) + self.dense.bias.to(cfg.dtype)
        else:
            x = linear(x, self.dense, cfg.dtype)
        scale, bias, eps = self.LayerNorm.weight, self.LayerNorm.bias, cfg.layer_norm_eps
        rate = cfg.hidden_dropout_prob if generator is not None else 0.0
        if cfg.use_fused_layer_norm:
            if rate > 0.0:
                seed = draw_seed(generator)
                if self.mesh is not None:
                    seed = self.mesh.data_seed(seed)
                return fused_dropout_add_layer_norm(x, res, scale, bias, seed, rate, eps)
            return fused_add_layer_norm(x, res, scale, bias, eps)
        x = dropout(x, rate, generator, cfg, self.mesh)
        return reference_add_layer_norm(x, res, scale, bias, eps)


class SelfAttention(nn.Module):
    """Multi-head self-attention plus its epilogue (reference
    modeling.py:207-276; HF ``attention`` = ``self`` + ``output``), routed
    as JAX ``encoder.py:256-311``: with ``use_flash_attention`` the packed
    kernels K1/K2, or K13/K14 with ``flash_save_probs``, or the heads-major
    K11/K12 with ``packed_qkv=False``; otherwise, and whenever
    ``output_probs`` asks for the probabilities, the einsum path with fp32
    scores. Returns ``(out, probs)``: the fp32 softmax ``[B, H, T, T]`` with
    ``output_probs``, else None. Under tensor parallelism the rank computes
    its own heads (see the module docstring)."""

    mesh = None

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        self.self = FusedQKV(cfg)
        self.output = ResidualNorm(cfg, cfg.num_attention_heads * cfg.head_dim)

    def forward(self, hidden, attn_bias, generator=None, output_probs: bool = False):
        cfg, mesh = self.cfg, self.mesh
        D = cfg.head_dim
        H = self.self.query.weight.shape[0] // D  # this model rank's heads
        rate = cfg.attention_probs_dropout_prob if generator is not None else 0.0
        x = copy_to_model(hidden, mesh)
        probs = None
        if cfg.use_flash_attention and not output_probs:
            seed = draw_seed(generator) if rate > 0.0 else None
            if not cfg.packed_qkv:
                ctx = flash_attention_heads_major(self.self(x, "heads_major"), attn_bias, rate, seed, mesh=mesh)
                return self.output(ctx, hidden, generator, heads_major=True), None
            qkv, qkv_bias = self.self(x, "packed")
            ctx = flash_attention_packed(qkv, H, attn_bias, rate, seed, qkv_bias=qkv_bias,
                                         save_probs=cfg.flash_save_probs, mesh=mesh)
        else:
            q, k, v = self.self(x, "split").unbind(dim=2)  # [B, T, H, D]
            scale = 1.0 / math.sqrt(D)
            scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            scores = scores * scale + attn_bias.float()
            probs = torch.softmax(scores, dim=-1)
            p = seeded_dropout(probs.to(cfg.dtype), rate, generator, mesh, per_model=True)
            ctx = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(*hidden.shape[:-1], H * D)
            if output_probs and mesh is not None and mesh.model_size > 1:
                probs = gather_slices(probs.detach(), 1, mesh.model_index, mesh.model_size, mesh.model_group)
        return self.output(ctx, hidden, generator), (probs if output_probs else None)


class Intermediate(nn.Module):
    """FFN up projection and exact-erf GELU (reference modeling.py:295-305);
    column-parallel under tensor parallelism."""

    mesh = None

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, hidden):
        return F.gelu(linear(copy_to_model(hidden, self.mesh), self.dense, self.cfg.dtype))


class TransformerLayer(nn.Module):
    """Post-LN BERT layer: attention -> add&norm -> FFN -> add&norm. Returns
    ``(hidden, probs)``, probs as :class:`SelfAttention` gives them."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.attention = SelfAttention(cfg)
        self.intermediate = Intermediate(cfg)
        self.output = ResidualNorm(cfg, cfg.intermediate_size)

    def forward(self, hidden, attn_bias, generator=None, output_probs: bool = False):
        hidden, probs = self.attention(hidden, attn_bias, generator, output_probs)
        return self.output(self.intermediate(hidden), hidden, generator), probs


class TransformerEncoder(nn.Module):
    """The layer stack, a plain list (reference modeling.py:344-371).
    Returns ``(hidden, probs)``: the layers' probabilities stacked to
    ``[L, B, H, T, T]`` when collected (``output_probs`` or
    ``cfg.output_attention_weights``), else None."""

    def __init__(self, cfg: VisualBertConfig):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_hidden_layers))

    def forward(self, hidden, attn_bias, generator=None, output_probs: bool = False):
        collect = output_probs or self.cfg.output_attention_weights
        all_probs = []
        for layer in self.layer:
            hidden, probs = layer(hidden, attn_bias, generator, collect)
            all_probs.append(probs)
        return hidden, (torch.stack(all_probs) if collect else None)


class VisualBertEmbeddings(nn.Module):
    """Joint text + visual embeddings (reference modeling.py:1169-1257).

    Visual tokens: projected region features + visual token type + a
    constant position row (index 0 of the visual table), plus, when
    ``image_text_alignment`` [B, Tv, A] (-1 pad) is given, the mean of the
    aligned words' text position embeddings (modeling.py:1223-1245)."""

    mesh = None

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
        return dropout(out, cfg.hidden_dropout_prob, generator, cfg, self.mesh)


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
    Returns ``(sequence_output, pooled_output, attention_probs)``, the last
    ``[L, B, H, T, T]`` fp32 when collected (see :class:`TransformerEncoder`),
    else None. The split path has no joint probabilities to give, and
    raises when they are asked for (JAX returns None there)."""

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
                visual_token_type_ids=None, image_text_alignment=None, generator=None,
                output_attention_probs: bool = False):
        cfg = self.cfg
        B, Tt = input_ids.shape
        Tv = 0 if visual_embeddings is None else visual_embeddings.shape[1]
        if attention_mask is None:
            attention_mask = torch.ones((B, Tt + Tv), dtype=torch.long, device=input_ids.device)
        hidden = self.embeddings(input_ids, token_type_ids, visual_embeddings, visual_token_type_ids,
                                 image_text_alignment, generator)
        attn_bias = mask_to_bias(attention_mask)
        if cfg.bypass_transformer and visual_embeddings is not None:
            if output_attention_probs or cfg.output_attention_weights:
                raise ValueError("bypass_transformer has no joint attention probabilities to collect; "
                                 "turn off output_attention_probs / output_attention_weights")
            text_out, _ = self.encoder(hidden[:, :Tt], attn_bias[..., :Tt], generator)
            joint = torch.cat([text_out, hidden[:, Tt:]], dim=1)
            seq_out, probs = self.additional_layer(joint, attn_bias, generator)
        else:
            seq_out, probs = self.encoder(hidden, attn_bias, generator, output_attention_probs)
        return seq_out, self.pooler(seq_out), probs

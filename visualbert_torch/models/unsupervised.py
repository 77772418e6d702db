"""Unsupervised VisualBERT, the NAACL-2021 stack (counterpart of
``visualbert_tpu/models/unsupervised.py``; reference
``unsupervised_visualbert/src/lxrt/modeling.py`` in its ``visualbert_style``
mode, :769-886): one encoder over ``[text ; detector tags ; regions]``.

  * text token   = LN(word + position + token type)                (:498-647)
  * tag token    = (LN(symbolic_emb(tag)) + LN(box_fc(box))) / 2   (:579-612)
  * region token = (LN(visn_fc(feat)) + LN(box_fc(box))) / 2       (:616-627)
  * losses (:1339-1465): MLM (CE ignoring -1), sentence-image matched
    (2-way CE), masked-object and masked-attribute CE x (1 / 0.15), the
    masked-feature SmoothL1 x (1 / 0.15), the masked-tag CE over the
    symbolic vocabulary, and the optional QA CE.

A batch may hold any of the three streams: V&L, text-only and image-only
batches (the hybrid training mix) run the same model; each loss runs when
its stream and labels are there. With ``fused_mlm_xent`` and labels, the
MLM loss runs the fused cross-entropy (``ops/mlm_xent.py``, K4-K6) over
every text row, labels -1 included, and the output holds no
``mlm_logits``. The embeddings' dropout is JAX's stock ``nn.Dropout``
(:func:`seeded_dropout`), not a ``fast_dropout`` site, so a step runs the
encoder's 24 sites and no more.

Parameters carry the reference LXRT names that
``visualbert_tpu/tools/import_torch.py::convert_lxrt_state_dict`` reads
(``bert.embeddings.*``, ``bert.encoder.layer.{i}.*``, ``bert.pooler``,
``cls.predictions``, ``cls.seq_relationship``, ``obj_predict_head``,
``symbolic_head.predictions``, ``answer_head.logit_fc.{0,2,3}``); the tied
decoders appear under their own names in the state dict as well.
:func:`flax_path` names each parameter's place in the Flax tree, and the
models decide weight decay on it as JAX's optimizer does (ROADMAP.md C9).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from visualbert_torch.config import VisualBertConfig
from visualbert_torch.models import losses
from visualbert_torch.models.encoder import (Pooler, TransformerEncoder, init_weights, linear, mask_to_bias,
                                             seeded_dropout)
from visualbert_torch.models.heads import LMPredictionHead, MLMTransform, PreTrainingHeads
from visualbert_torch.ops.layer_norm import layer_norm_f32
from visualbert_torch.ops.mlm_xent import mlm_xent, supports_mesh


@dataclasses.dataclass(frozen=True)
class UnsupervisedConfig:
    """The reference's VisualConfig (modeling.py:141-188) and the task
    switches, as JAX's."""

    bert: VisualBertConfig = dataclasses.field(default_factory=VisualBertConfig.base)
    visual_feat_dim: int = 2048
    visual_pos_dim: int = 4
    obj_id_num: int = 1600
    attr_id_num: int = 400
    symbolic_vocab_size: int = 2003
    num_answers: int = 9500
    visual_loss_weight: float = 1.0 / 0.15
    task_mask_lm: bool = True
    task_matched: bool = True
    task_obj_predict: bool = True
    task_qa: bool = False
    joint_layer_norm: bool = False
    divide_by_2: bool = True
    # tags embedded with the word table and predicted by the MLM head over
    # the wordpiece vocabulary (modeling.py:583-586, 1440-1446)
    use_bert_input_for_tags: bool = False

    def replace(self, **kw) -> "UnsupervisedConfig":
        return dataclasses.replace(self, **kw)


class ThreeStreamEmbeddings(nn.Module):
    """Text, tag and region tokens, each stream under its own LayerNorm
    (one joint LayerNorm with ``joint_layer_norm``), concatenated and
    dropped out."""

    mesh = None

    def __init__(self, ucfg: UnsupervisedConfig):
        super().__init__()
        self.ucfg = ucfg
        cfg = ucfg.bert
        E = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, E)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, E)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, E)
        if not ucfg.use_bert_input_for_tags:
            self.symbolic_embedding = nn.Embedding(ucfg.symbolic_vocab_size, E)
        self.LayerNorm = nn.LayerNorm(E, eps=cfg.layer_norm_eps)
        self.visn_fc = nn.Linear(ucfg.visual_feat_dim, E)
        self.box_fc = nn.Linear(ucfg.visual_pos_dim, E)
        if not ucfg.joint_layer_norm:  # the streams' own norms
            self.visn_layer_norm = nn.LayerNorm(E, eps=cfg.layer_norm_eps)
            self.box_layer_norm = nn.LayerNorm(E, eps=cfg.layer_norm_eps)
            self.tag_layer_norm = nn.LayerNorm(E, eps=cfg.layer_norm_eps)

    def _norm(self, x, ln: nn.LayerNorm):
        return layer_norm_f32(x, ln.weight, ln.bias, self.ucfg.bert.layer_norm_eps).to(self.ucfg.bert.dtype)

    def _embed(self, table: nn.Embedding, idx):
        return F.embedding(idx, table.weight).to(self.ucfg.bert.dtype)

    def _pair(self, a, box):
        """The mean (or sum) of a tag or region token and its box token."""
        ucfg = self.ucfg
        b = linear(box, self.box_fc, ucfg.bert.dtype)
        if not ucfg.joint_layer_norm:
            b = self._norm(b, self.box_layer_norm)
        return (a + b) / 2 if ucfg.divide_by_2 else a + b

    def forward(self, input_ids=None, token_type_ids=None, visual_feats=None, boxes=None, visual_tags=None,
                visual_tags_box=None, generator: Optional[torch.Generator] = None):
        ucfg = self.ucfg
        cfg = ucfg.bert
        parts = []
        if input_ids is not None:
            if token_type_ids is None:
                token_type_ids = torch.zeros_like(input_ids)
            pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
            text = (self._embed(self.word_embeddings, input_ids) + self._embed(self.position_embeddings, pos)
                    + self._embed(self.token_type_embeddings, token_type_ids))
            parts.append(text if ucfg.joint_layer_norm else self._norm(text, self.LayerNorm))
        if visual_tags is not None:
            table = self.word_embeddings if ucfg.use_bert_input_for_tags else self.symbolic_embedding
            tag = self._embed(table, visual_tags)
            if not ucfg.joint_layer_norm:
                tag = self._norm(tag, self.tag_layer_norm)
            parts.append(self._pair(tag, visual_tags_box))
        if visual_feats is not None:
            x = linear(visual_feats, self.visn_fc, cfg.dtype)
            if not ucfg.joint_layer_norm:
                x = self._norm(x, self.visn_layer_norm)
            parts.append(self._pair(x, boxes))
        out = torch.cat(parts, dim=1)
        if ucfg.joint_layer_norm:
            out = self._norm(out, self.LayerNorm)
        return seeded_dropout(out, cfg.hidden_dropout_prob, generator, self.mesh)


class LXRTModel(nn.Module):
    """``bert``: the embeddings, the encoder and the pooler."""

    def __init__(self, ucfg: UnsupervisedConfig):
        super().__init__()
        ucfg.bert.check_ported()
        self.embeddings = ThreeStreamEmbeddings(ucfg)
        self.encoder = TransformerEncoder(ucfg.bert)
        self.pooler = Pooler(ucfg.bert)


class VisualObjHead(nn.Module):
    """A transform and one decoder a visual loss (modeling.py:971-996):
    object and attribute logits and the regressed feature, fp32."""

    def __init__(self, ucfg: UnsupervisedConfig):
        super().__init__()
        cfg = ucfg.bert
        self.dtype = cfg.dtype
        self.transform = MLMTransform(cfg)
        self.decoder_dict = nn.ModuleDict({
            "obj": nn.Linear(cfg.hidden_size, ucfg.obj_id_num),
            "attr": nn.Linear(cfg.hidden_size, ucfg.attr_id_num),
            "feat": nn.Linear(cfg.hidden_size, ucfg.visual_feat_dim),
        })

    def forward(self, hidden) -> Dict[str, torch.Tensor]:
        h = self.transform(hidden)
        return {k: linear(h, layer, self.dtype).float() for k, layer in self.decoder_dict.items()}


class SymbolicHead(nn.Module):
    """``symbolic_head``: the masked-tag head, a copy of ``cls.predictions``
    whose decoder is the symbolic table (modeling.py:1333-1337)."""

    def __init__(self, ucfg: UnsupervisedConfig):
        super().__init__()
        self.predictions = LMPredictionHead(ucfg.bert, ucfg.symbolic_vocab_size)


class AnswerHead(nn.Module):
    """hidden -> 2 hidden -> exact-erf GELU -> LayerNorm (eps 1e-12) ->
    answers (modeling.py:956-968), fp32 logits; ``logit_fc`` keeps the
    reference's Sequential indices (0 dense, 2 norm, 3 dense)."""

    def __init__(self, ucfg: UnsupervisedConfig):
        super().__init__()
        cfg = ucfg.bert
        self.dtype = cfg.dtype
        H = cfg.hidden_size
        self.logit_fc = nn.Sequential(nn.Linear(H, 2 * H), nn.GELU(), nn.LayerNorm(2 * H, eps=1e-12),
                                      nn.Linear(2 * H, ucfg.num_answers))

    def forward(self, pooled):
        fc1, _, norm, fc2 = self.logit_fc
        x = F.gelu(linear(pooled, fc1, self.dtype))
        x = layer_norm_f32(x, norm.weight, norm.bias, 1e-12).to(self.dtype)
        return linear(x, fc2, self.dtype).float()


def _masked_ce(logits, labels, conf):
    """The reference's masked CE of the object and attribute heads: the NLL
    where a label is given, times its confidence, averaged over EVERY
    position (:365-370)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    nll = torch.where(labels >= 0, nll, torch.zeros((), device=nll.device))
    return losses.batch_mean(nll * conf.float())


class UnsupervisedVisualBert(nn.Module):
    """The joint model and its loss assembly (``LXRTPretraining``,
    modeling.py:1298-1465). Forward takes a batch dict and an optional
    dropout generator (dropout on iff given); with
    ``output_attention_probs`` the output also holds the encoder's
    ``attention_weights`` [L, B, H, T, T].

    Batch keys, each stream optional: ``input_ids``, ``token_type_ids``,
    ``input_mask`` [B, Tt], ``masked_lm_labels`` [B, Tt] (-1 ignored);
    ``visual_tags``, ``visual_tags_mask`` [B, Nt], ``visual_tags_box``
    [B, Nt, 4], ``visual_tags_objective`` [B, Nt]; ``visual_feats``
    [B, Nv, Df], ``boxes`` [B, Nv, 4], ``visual_feats_mask`` [B, Nv],
    ``obj_labels``/``attr_labels`` [B, Nv], ``obj_conf``/``attr_conf``,
    ``feat_target`` [B, Nv, Df], ``feat_mask`` [B, Nv]; ``matched_label``
    [B] and ``ans`` [B] (-1 ignored)."""

    mesh = None

    def __init__(self, ucfg: UnsupervisedConfig):
        super().__init__()
        self.ucfg = ucfg
        cfg = ucfg.bert
        self.bert = LXRTModel(ucfg)
        # the MLM head and the matched classifier; forward calls their parts
        self.cls = PreTrainingHeads(cfg)
        self.cls.predictions.decoder.weight = self.bert.embeddings.word_embeddings.weight
        if ucfg.task_obj_predict:
            self.obj_predict_head = VisualObjHead(ucfg)
            if not ucfg.use_bert_input_for_tags:
                self.symbolic_head = SymbolicHead(ucfg)
                self.symbolic_head.predictions.decoder.weight = self.bert.embeddings.symbolic_embedding.weight
        if ucfg.task_qa:
            self.answer_head = AnswerHead(ucfg)

    def init_weights(self, generator: torch.Generator) -> "UnsupervisedVisualBert":
        init_weights(self, self.ucfg.bert, generator)
        return self

    def decays(self, name: str, no_decay: Iterable[str] = ()) -> bool:
        """Whether BertAdam decays the parameter ``name``: JAX's decision on
        its Flax path (``default_decay_mask`` and the ``no_decay``
        substrings), not the port's on the torch name (ROADMAP.md C9)."""
        return flax_decays(flax_path(name), no_decay)

    def _encode(self, batch: Dict[str, torch.Tensor], generator, output_attention_probs: bool = False):
        """(sequence output, pooled output, the encoder's [L, B, H, T, T]
        probabilities when asked for) over the streams present."""
        masks = [batch[k] for k, stream in (("input_mask", "input_ids"), ("visual_tags_mask", "visual_tags"),
                                             ("visual_feats_mask", "visual_feats")) if batch.get(stream) is not None]
        hidden = self.bert.embeddings(batch.get("input_ids"), batch.get("token_type_ids"), batch.get("visual_feats"),
                                      batch.get("boxes"), batch.get("visual_tags"), batch.get("visual_tags_box"),
                                      generator)
        seq_out, probs = self.bert.encoder(hidden, mask_to_bias(torch.cat(masks, dim=1)), generator,
                                           output_attention_probs)
        return seq_out, self.bert.pooler(seq_out), probs

    def forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                output_attention_probs: bool = False):
        ucfg = self.ucfg
        cfg = ucfg.bert
        seq_out, pooled, probs = self._encode(batch, generator, output_attention_probs)
        input_ids, visual_tags = batch.get("input_ids"), batch.get("visual_tags")
        # the streams (modeling.py:753-767 _split_with_none)
        Tt = 0 if input_ids is None else input_ids.shape[1]
        Nt = 0 if visual_tags is None else visual_tags.shape[1]
        lang_out = seq_out[:, :Tt] if Tt else None
        tags_out = seq_out[:, Tt:Tt + Nt] if Nt else None
        visn_out = seq_out[:, Tt + Nt:] if batch.get("visual_feats") is not None else None

        out: Dict[str, torch.Tensor] = {}
        total = torch.zeros((), device=seq_out.device)
        if lang_out is not None:
            labels = batch.get("masked_lm_labels")
            out["matched_logits"] = matched_logits = linear(pooled, self.cls.seq_relationship, cfg.dtype).float()
            pred = self.cls.predictions
            if (cfg.fused_mlm_xent and ucfg.task_mask_lm and labels is not None
                    and supports_mesh(labels.numel(), self.mesh)):
                # every text row, -1 labels included, through K4-K6 (rows
                # split over the model group under a mesh, JAX :310-330)
                x = pred.transform(lang_out)
                nll, _ = mlm_xent(x.reshape(-1, x.shape[-1]), pred.decoder.weight.to(cfg.dtype), pred.bias,
                                  labels.reshape(-1), mesh=self.mesh)
                out["masked_lm_loss"] = loss = losses.masked_nll_mean(nll, labels)
                total = total + loss
            else:
                out["mlm_logits"] = mlm_logits = pred(lang_out)
                if ucfg.task_mask_lm and labels is not None:
                    out["masked_lm_loss"] = loss = losses.cross_entropy_ignore_index(mlm_logits, labels)
                    total = total + loss
            if ucfg.task_matched and batch.get("matched_label") is not None:
                out["matched_loss"] = loss = losses.cross_entropy_ignore_index(matched_logits, batch["matched_label"])
                total = total + loss
            if ucfg.task_qa and batch.get("ans") is not None:
                ans = batch["ans"]
                out["answer_logits"] = ans_logits = self.answer_head(pooled)
                out["qa_loss"] = loss = losses.cross_entropy_ignore_index(ans_logits, ans)
                total = total + loss
                # over the labelled rows (reference LXMERTEvaluator, lxmert_data.py:892-946)
                valid = ans >= 0
                out["qa_accuracy"] = (((ans_logits.argmax(dim=-1) == ans) & valid).sum()
                                     / losses.denominator(valid.sum()).clamp_min(1))

        if ucfg.task_obj_predict and visn_out is not None and batch.get("obj_labels") is not None:
            preds = self.obj_predict_head(visn_out)
            w = ucfg.visual_loss_weight
            out["obj_loss"] = _masked_ce(preds["obj"], batch["obj_labels"], batch["obj_conf"]) * w
            out["attr_loss"] = _masked_ce(preds["attr"], batch["attr_labels"], batch["attr_conf"]) * w
            feat_l = losses.smooth_l1(preds["feat"], batch["feat_target"]).mean(dim=-1)
            out["feat_loss"] = losses.batch_mean(feat_l * batch["feat_mask"].float()) * w
            total = total + out["obj_loss"] + out["attr_loss"] + out["feat_loss"]

        if ucfg.task_obj_predict and tags_out is not None and batch.get("visual_tags_objective") is not None:
            # with use_bert_input_for_tags the MLM head over the word
            # vocabulary (modeling.py:1440-1446), else the symbolic head
            head = self.cls.predictions if ucfg.use_bert_input_for_tags else self.symbolic_head.predictions
            out["masked_tag_loss"] = loss = losses.cross_entropy_ignore_index(head(tags_out),
                                                                              batch["visual_tags_objective"])
            total = total + loss

        out["loss"] = total
        out["pooled_output"] = pooled
        if output_attention_probs:
            out["attention_weights"] = probs
        return out


class UnsupervisedVQAModel(UnsupervisedVisualBert):
    """Fine-tuning model (reference ``vqa_model.py:16-71``, loss
    ``tasks/vqa.py:104-107``): the encoder with every objective off and an
    ``AnswerHead``; BCE-with-logits times the number of answers against the
    soft ``target`` and the soft accuracy, both weighted by
    ``example_weight``. Its parameters are the JAX tree's: the trunk's
    ``cls`` (its MLM head and matched classifier, which the loss never
    reaches) and ``answer_head``; its Flax paths lie under ``trunk/`` but
    the answer head's."""

    def __init__(self, ucfg: UnsupervisedConfig):
        super().__init__(ucfg.replace(task_mask_lm=False, task_matched=False, task_obj_predict=False, task_qa=False))
        self.answer_head = AnswerHead(ucfg)

    def decays(self, name: str, no_decay: Iterable[str] = ()) -> bool:
        path = flax_path(name)
        return flax_decays(path if path.startswith("answer_head/") else "trunk/" + path, no_decay)

    def forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                output_attention_probs: bool = False):
        _, pooled, probs = self._encode(batch, generator, output_attention_probs)
        logits = self.answer_head(pooled)
        out: Dict[str, torch.Tensor] = {"logits": logits}
        if output_attention_probs:
            out["attention_weights"] = probs
        target = batch.get("target")
        if target is not None:
            w = batch.get("example_weight")
            out["loss"] = losses.binary_cross_entropy_with_logits(logits, target, w) * logits.shape[-1]
            out["accuracy"] = losses.weighted_mean(target.float().gather(1, logits.argmax(dim=-1)[:, None])[:, 0], w)
        return out


# ---- the Flax tree's names ----

# module prefixes, port -> Flax (JAX import_torch.py:197-321 in reverse);
# the encoder's layers are matched by _LAYER, the output biases by _PARAMS
_MODULES = (
    ("bert.embeddings.LayerNorm", "embeddings/text_norm"),
    ("bert.embeddings.visn_layer_norm", "embeddings/visn_norm"),
    ("bert.embeddings.box_layer_norm", "embeddings/box_norm"),
    ("bert.embeddings.tag_layer_norm", "embeddings/tag_norm"),
    ("bert.embeddings.", "embeddings/"),
    ("bert.pooler.dense", "pooler/dense"),
    ("cls.predictions.transform.LayerNorm", "mlm_transform/norm"),
    ("cls.predictions.transform.dense", "mlm_transform/dense"),
    ("cls.predictions.decoder", "embeddings/word_embeddings"),
    ("cls.seq_relationship", "seq_relationship"),
    ("obj_predict_head.transform.LayerNorm", "obj_head/transform/norm"),
    ("obj_predict_head.transform.dense", "obj_head/transform/dense"),
    ("obj_predict_head.decoder_dict.", "obj_head/"),
    ("symbolic_head.predictions.transform.LayerNorm", "tag_transform/norm"),
    ("symbolic_head.predictions.transform.dense", "tag_transform/dense"),
    ("symbolic_head.predictions.decoder", "embeddings/symbolic_embedding"),
    ("answer_head.logit_fc.0", "answer_head/fc1"),
    ("answer_head.logit_fc.2", "answer_head/norm"),
    ("answer_head.logit_fc.3", "answer_head/fc2"),
)
_PARAMS = {"cls.predictions.bias": "mlm_bias", "symbolic_head.predictions.bias": "tag_bias"}
_LAYER = re.compile(r"bert\.encoder\.layer\.\d+\.(.+)\.(weight|bias)")
_LAYER_MODULES = {
    "attention.self.query": "attention/qkv", "attention.self.key": "attention/qkv",
    "attention.self.value": "attention/qkv", "attention.output.dense": "attention/out",
    "attention.output.LayerNorm": "attention_norm", "intermediate.dense": "intermediate",
    "output.dense": "output", "output.LayerNorm": "output_norm",
}


def flax_path(name: str) -> str:
    """The '/'-joined path in the JAX ``UnsupervisedVisualBert`` tree (the
    scan layout, ``encoder/layers/...``) of the port parameter ``name``; a
    port weight is a Flax ``embedding``, ``kernel`` or norm ``scale``."""
    if name in _PARAMS:
        return _PARAMS[name]
    m = _LAYER.fullmatch(name)
    if m:
        module = "encoder/layers/" + _LAYER_MODULES[m.group(1)]
        leaf = m.group(2)
    else:
        module, leaf = name.rsplit(".", 1)
        for port, flax in _MODULES:
            if module.startswith(port):
                module = flax + module[len(port):].replace(".", "/")
                break
        else:
            raise KeyError(f"{name}: no Flax counterpart")
    if leaf == "weight":
        leaf = ("embedding" if module.endswith(("_embeddings", "_embedding")) else
                "scale" if module.rsplit("/", 1)[-1].endswith("norm") else "kernel")
    return f"{module}/{leaf}"


def flax_decays(path: str, no_decay: Iterable[str] = ()) -> bool:
    """JAX ``train/optimizer.py``'s weight-decay decision on a Flax path:
    ``default_decay_mask`` (no decay for a path ending in ``/bias`` or
    ``/scale`` or holding ``norm`` or ``decoder_bias``) and then the
    ``no_decay`` substrings (``from_config``)."""
    p = path.lower()
    if p.endswith(("/bias", "/scale")) or "norm" in p or "decoder_bias" in p:
        return False
    return not any(s.lower() in p for s in no_decay)

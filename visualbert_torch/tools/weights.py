"""Weight bridge: a ``{torch_name: np.ndarray}`` state dict, as
``visualbert_tpu/tools/export_torch.py::export_state_dict`` emits it from
Flax params, loaded into a port module with ``strict=True``.

The port never imports the JAX package; whoever holds a Flax checkpoint
exports it on the JAX side and hands the arrays over. ``export_state_dict``
emits no ``flickr_attention`` entries: :func:`flickr_attention_state` turns
that Flax subtree into them, with numpy only. :func:`detector_model_state`
joins the two exports of a Flax ``VisualBertDetectorModel`` (its ``bert``
subtree through ``export_state_dict``, its ``detector`` subtree through
``export_resnet50_state_dict``) under the port model's prefixes.
:func:`unsupervised_state` turns the Flax tree of an
``UnsupervisedVisualBert`` or ``UnsupervisedVQAModel`` into the port
model's state dict, with numpy only; :func:`unsup_e2e_state` joins it with a
detector export for the end-to-end model.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def load_state(module: torch.nn.Module, state: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy ``state`` into ``module``: every key must match a parameter and
    every parameter must be covered (the tied MLM decoder appears under
    both of its names). Shapes must agree."""
    tensors: Dict[str, torch.Tensor] = {k: torch.tensor(np.asarray(v)) for k, v in state.items()}
    module.load_state_dict(tensors, strict=True)
    return module


def flickr_attention_state(subtree: Mapping) -> Dict[str, np.ndarray]:
    """The Flax ``flickr_attention`` params (``{"query"|"key": {"kernel",
    "bias"}}``, leaves plain or boxed) as the reference-named entries
    ``flickr_attention.{query,key}.{weight,bias}`` (the names
    ``visualbert_tpu/tools/import_torch.py`` reads); a kernel [in, out]
    becomes a weight [out, in]."""
    out = {}
    for name in ("query", "key"):
        dense = subtree[name]
        out[f"flickr_attention.{name}.weight"] = np.asarray(getattr(dense["kernel"], "value", dense["kernel"]),
                                                            np.float32).T
        out[f"flickr_attention.{name}.bias"] = np.asarray(getattr(dense["bias"], "value", dense["bias"]),
                                                          np.float32)
    return out


def detector_model_state(bert_state: Mapping[str, np.ndarray],
                         detector_state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The state dict of the port's ``VisualBertDetectorModel`` from the two
    exports of a Flax one: ``bert_state`` is ``export_state_dict`` of its
    ``bert`` subtree (keys ``bert.*`` and the head's ``classifier.*`` or
    ``cls.*``), ``detector_state`` is ``export_resnet50_state_dict`` of its
    ``detector`` subtree (torchvision keys). They land under ``bert.`` and
    ``detector.``."""
    out = {f"bert.{k}": np.asarray(v) for k, v in bert_state.items()}
    out.update((f"detector.{k}", np.asarray(v)) for k, v in detector_state.items())
    return out


def unsup_e2e_state(detector_state: Mapping[str, np.ndarray], trunk_params: Mapping) -> Dict[str, np.ndarray]:
    """The state dict of the port's ``UnsupervisedEndToEnd`` from a Flax
    one: ``detector_state`` is ``export_resnet50_state_dict`` of its
    ``detector`` subtree (torchvision keys, the heads included),
    ``trunk_params`` its ``trunk`` subtree. They land under ``detector.``
    (as :func:`detector_model_state` lands them) and ``trunk.``."""
    out = detector_model_state({}, detector_state)
    out.update((f"trunk.{k}", v) for k, v in unsupervised_state(trunk_params).items())
    return out


def _leaf(x) -> np.ndarray:
    """A Flax leaf, boxed (``nn.Partitioned``) or plain, as fp32 numpy."""
    return np.asarray(getattr(x, "value", x), np.float32)


def _layer_state(layer: Mapping, prefix: str, H: int) -> Dict[str, np.ndarray]:
    """One encoder layer's Flax subtree (qkv kernel [E, 3, heads, D], bias
    [3, heads, D]; out kernel [heads, D, E]) as the port's names."""
    out = {}
    att = layer["attention"]
    qk, qb = _leaf(att["qkv"]["kernel"]), _leaf(att["qkv"]["bias"])
    for j, name in enumerate(("query", "key", "value")):
        out[f"{prefix}.attention.self.{name}.weight"] = qk[:, j].reshape(H, -1).T
        out[f"{prefix}.attention.self.{name}.bias"] = qb[j].reshape(-1)
    ok = _leaf(att["out"]["kernel"])
    out[f"{prefix}.attention.output.dense.weight"] = ok.reshape(-1, ok.shape[-1]).T
    out[f"{prefix}.attention.output.dense.bias"] = _leaf(att["out"]["bias"])
    for flax, port in (("attention_norm", "attention.output.LayerNorm"), ("output_norm", "output.LayerNorm")):
        out[f"{prefix}.{port}.weight"] = _leaf(layer[flax]["scale"])
        out[f"{prefix}.{port}.bias"] = _leaf(layer[flax]["bias"])
    for flax, port in (("intermediate", "intermediate.dense"), ("output", "output.dense")):
        out[f"{prefix}.{port}.weight"] = _leaf(layer[flax]["kernel"]).T
        out[f"{prefix}.{port}.bias"] = _leaf(layer[flax]["bias"])
    return out


def unsupervised_state(params: Mapping) -> Dict[str, np.ndarray]:
    """The port's state dict of the JAX ``UnsupervisedVisualBert`` tree
    ``params``, or of an ``UnsupervisedVQAModel`` one (its ``trunk`` and
    ``answer_head``), as nested dicts of arrays, leaves plain or boxed, the
    encoder in the scan layout (``encoder/layers``, stacked) or per layer
    (``encoder/layer_{i}``). The names are the reference LXRT checkpoint's
    that ``visualbert_tpu/tools/import_torch.py::convert_lxrt_state_dict``
    reads; the tied decoders appear under their names too."""
    tree = dict(params)
    if "trunk" in tree:
        tree = dict(tree.pop("trunk"), **tree)
    out: Dict[str, np.ndarray] = {}

    def dense(node, prefix):
        out[f"{prefix}.weight"] = _leaf(node["kernel"]).T
        out[f"{prefix}.bias"] = _leaf(node["bias"])

    def norm(node, prefix):
        out[f"{prefix}.weight"] = _leaf(node["scale"])
        out[f"{prefix}.bias"] = _leaf(node["bias"])

    def transform(node, prefix):
        dense(node["dense"], f"{prefix}.dense")
        norm(node["norm"], f"{prefix}.LayerNorm")

    emb = tree["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings", "symbolic_embedding"):
        if name in emb:
            out[f"bert.embeddings.{name}.weight"] = _leaf(emb[name]["embedding"])
    for flax, port in (("text_norm", "LayerNorm"), ("visn_norm", "visn_layer_norm"), ("box_norm", "box_layer_norm"),
                       ("tag_norm", "tag_layer_norm")):
        if flax in emb:  # joint_layer_norm has the text norm alone
            norm(emb[flax], f"bert.embeddings.{port}")
    dense(emb["visn_fc"], "bert.embeddings.visn_fc")
    dense(emb["box_fc"], "bert.embeddings.box_fc")

    enc = tree["encoder"]
    H = out["bert.embeddings.word_embeddings.weight"].shape[1]
    if "layers" in enc:
        n = _leaf(enc["layers"]["attention_norm"]["scale"]).shape[0]
        layers = [_unstack(enc["layers"], i) for i in range(n)]
    else:
        layers = [enc[f"layer_{i}"] for i in range(len(enc))]
    for i, layer in enumerate(layers):
        out.update(_layer_state(layer, f"bert.encoder.layer.{i}", H))
    dense(tree["pooler"]["dense"], "bert.pooler.dense")

    transform(tree["mlm_transform"], "cls.predictions.transform")
    out["cls.predictions.bias"] = _leaf(tree["mlm_bias"])
    out["cls.predictions.decoder.weight"] = out["bert.embeddings.word_embeddings.weight"]
    dense(tree["seq_relationship"], "cls.seq_relationship")
    if "obj_head" in tree:
        transform(tree["obj_head"]["transform"], "obj_predict_head.transform")
        for key in ("obj", "attr", "feat"):
            dense(tree["obj_head"][key], f"obj_predict_head.decoder_dict.{key}")
    if "tag_transform" in tree:
        transform(tree["tag_transform"], "symbolic_head.predictions.transform")
        out["symbolic_head.predictions.bias"] = _leaf(tree["tag_bias"])
        out["symbolic_head.predictions.decoder.weight"] = out["bert.embeddings.symbolic_embedding.weight"]
    if "answer_head" in tree:
        head = tree["answer_head"]
        dense(head["fc1"], "answer_head.logit_fc.0")
        norm(head["norm"], "answer_head.logit_fc.2")
        dense(head["fc2"], "answer_head.logit_fc.3")
    return out


def _unstack(node, i: int):
    """Layer ``i`` of a scan-stacked subtree."""
    if isinstance(node, Mapping):
        return {k: _unstack(v, i) for k, v in node.items()}
    return _leaf(node)[i]

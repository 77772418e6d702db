"""Import reference PyTorch checkpoints (``.th``/``.pth``/``.bin``) into the
port's models: the port's copy of ``visualbert_tpu/tools/import_torch.py``
with the loading step that the JAX registry's ``_restore`` performs
(``visualbert_tpu/tasks/registry.py:218-231``).

The port's parameter names already are the reference's, so loading a
reference state dict by name would take more keys than the JAX package
does. :func:`restore_torch_file` therefore loads exactly what JAX loads: the
file's state dict goes through ``convert_state_dict`` (the reference
VisualBERT names, HF names, ``gamma``/``beta`` and ``module.``/``model.``
prefixes) and ``maybe_special_initialize`` into the Flax layout, is merged
over the model's own tree in that layout (:func:`model_tree`), non-strict
with a shape check (``merge_into``), and the merged tree goes back into the
model (:func:`load_tree`). Every other parameter keeps its value. As in the
JAX package, this tree lines up with ``VisualBertForTask`` alone: the
detector and unsupervised models' trees share no top-level key with it, so
nothing of such a file lands there (ROADMAP.md C10).

Also here, for checkpoints that a caller converts on purpose:
``convert_lxrt_state_dict`` and ``convert_lxrt_for_vqa`` (the unsupervised
stack's LXRT checkpoints) and ``convert_resnet50_state_dict`` (torchvision
or reference-detector ResNet50 keys; the port's stem is the 7 x 7 kernel,
so no space-to-depth rearrangement).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from visualbert_torch.tools.weights import unsupervised_state


def load_torch_file(path: str) -> Dict[str, np.ndarray]:
    """A .th/.pth/.bin checkpoint as {name: np.ndarray} (a ``{"model": ...}``
    wrapper unwrapped; entries that are not tensors dropped)."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "model" in state and isinstance(state["model"], dict):
        state = state["model"]
    return {k: v.detach().cpu().numpy() for k, v in state.items() if hasattr(v, "detach")}


_ALIASES = [
    # gamma/beta -> weight/bias (reference modeling.py:556-568)
    (r"\.gamma$", ".weight"),
    (r"\.beta$", ".bias"),
    # HF visual_bert naming -> reference naming
    (r"embeddings\.visual_projection\.", "embeddings.projection."),
    (r"embeddings\.visual_token_type_embeddings\.", "embeddings.token_type_embeddings_visual."),
    (r"embeddings\.visual_position_embeddings\.", "embeddings.position_embeddings_visual."),
    # HF MLM head naming
    (r"cls\.predictions\.transform\.", "cls.transform."),
    # DataParallel / wrapper prefixes
    (r"^module\.", ""),
    (r"^model\.", ""),
]


def _normalize(name: str) -> str:
    for pat, rep in _ALIASES:
        name = re.sub(pat, rep, name)
    return name


def _put(tree: Dict, path, value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def convert_state_dict(flat: Dict[str, np.ndarray], cfg, dtype=np.float32) -> Dict:
    """The nested Flax-layout tree of a reference VisualBERT state dict
    (JAX ``convert_state_dict``): only the keys present in ``flat`` are
    emitted, the encoder stacked (``bert/encoder/layers``); the tied MLM
    decoder is dropped."""
    flat = {_normalize(k): np.asarray(v, dtype=dtype) for k, v in flat.items()}
    H, nh, hd, L = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim, cfg.num_hidden_layers
    out: Dict = {}

    def linear(prefix):
        w = flat.get(prefix + ".weight")
        return None if w is None else (w.T, flat.get(prefix + ".bias"))

    def emb_prefix(name):
        for cand in (f"bert.embeddings.{name}", f"embeddings.{name}"):
            if cand + ".weight" in flat or cand + ".bias" in flat:
                return cand
        return None

    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings", "token_type_embeddings_visual",
                 "position_embeddings_visual"):
        p = emb_prefix(name)
        if p is not None:
            _put(out, ("bert", "embeddings", name, "embedding"), flat[p + ".weight"])
    p = emb_prefix("projection")
    if p is not None:
        w, b = linear(p)
        _put(out, ("bert", "embeddings", "projection", "kernel"), w)
        _put(out, ("bert", "embeddings", "projection", "bias"), b)
    p = emb_prefix("LayerNorm")
    if p is not None:
        _put(out, ("bert", "embeddings", "norm", "scale"), flat[p + ".weight"])
        _put(out, ("bert", "embeddings", "norm", "bias"), flat[p + ".bias"])

    def layer_prefix(i):
        for cand in (f"bert.encoder.layer.{i}", f"encoder.layer.{i}"):
            if cand + ".attention.self.query.weight" in flat:
                return cand
        return None

    if layer_prefix(0) is not None:
        stacks: Dict[tuple, list] = {}
        for i in range(L):
            pref = layer_prefix(i)
            if pref is None:
                raise KeyError(f"missing encoder layer {i}")
            ws, bs = [], []
            for name in ("query", "key", "value"):
                w, b = linear(f"{pref}.attention.self.{name}")
                ws.append(w.reshape(H, nh, hd))
                bs.append(b.reshape(nh, hd))
            layer = {("attention", "qkv", "kernel"): np.stack(ws, axis=1),
                     ("attention", "qkv", "bias"): np.stack(bs, axis=0)}
            w, b = linear(f"{pref}.attention.output.dense")
            layer[("attention", "out", "kernel")], layer[("attention", "out", "bias")] = w.reshape(nh, hd, H), b
            layer[("attention_norm", "scale")] = flat[f"{pref}.attention.output.LayerNorm.weight"]
            layer[("attention_norm", "bias")] = flat[f"{pref}.attention.output.LayerNorm.bias"]
            layer[("intermediate", "kernel")], layer[("intermediate", "bias")] = linear(f"{pref}.intermediate.dense")
            layer[("output", "kernel")], layer[("output", "bias")] = linear(f"{pref}.output.dense")
            layer[("output_norm", "scale")] = flat[f"{pref}.output.LayerNorm.weight"]
            layer[("output_norm", "bias")] = flat[f"{pref}.output.LayerNorm.bias"]
            for path, v in layer.items():
                stacks.setdefault(path, []).append(v)
        for path, vals in stacks.items():
            _put(out, ("bert", "encoder", "layers") + path, np.stack(vals, axis=0))

    for cand in ("bert.pooler.dense", "pooler.dense"):
        if cand + ".weight" in flat:
            w, b = linear(cand)
            _put(out, ("bert", "pooler", "dense", "kernel"), w)
            _put(out, ("bert", "pooler", "dense", "bias"), b)
            break

    if "cls.transform.dense.weight" in flat:
        w, b = linear("cls.transform.dense")
        _put(out, ("cls", "transform", "dense", "kernel"), w)
        _put(out, ("cls", "transform", "dense", "bias"), b)
        _put(out, ("cls", "transform", "norm", "scale"), flat["cls.transform.LayerNorm.weight"])
        _put(out, ("cls", "transform", "norm", "bias"), flat["cls.transform.LayerNorm.bias"])
    if "cls.predictions.bias" in flat:
        _put(out, ("cls", "decoder_bias"), flat["cls.predictions.bias"])
    if "cls.seq_relationship.weight" in flat:
        w, b = linear("cls.seq_relationship")
        _put(out, ("cls", "seq_relationship", "kernel"), w)
        _put(out, ("cls", "seq_relationship", "bias"), b)
    if "classifier.weight" in flat:
        w, b = linear("classifier")
        _put(out, ("classifier", "dense", "kernel"), w)
        _put(out, ("classifier", "dense", "bias"), b)
    if "flickr_attention.query.weight" in flat:
        for name in ("query", "key"):
            w, b = linear(f"flickr_attention.{name}")
            _put(out, ("flickr_attention", name, "kernel"), w)
            _put(out, ("flickr_attention", name, "bias"), b)
    return out


def task_state(tree: Dict, cfg) -> Dict[str, np.ndarray]:
    """The inverse of :func:`convert_state_dict` on a whole
    ``VisualBertForTask`` tree: the port's (reference) names, the tied
    decoder under its own name too (the port's copy of JAX
    ``export_state_dict``, plus the ``classifier`` and ``flickr_attention``
    heads)."""
    H, nh, hd = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    out: Dict[str, np.ndarray] = {}

    def dense(node, prefix):
        out[f"{prefix}.weight"] = np.asarray(node["kernel"]).T
        out[f"{prefix}.bias"] = np.asarray(node["bias"])

    trunk = tree["bert"]
    emb = trunk["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings", "token_type_embeddings_visual",
                 "position_embeddings_visual"):
        out[f"bert.embeddings.{name}.weight"] = np.asarray(emb[name]["embedding"])
    dense(emb["projection"], "bert.embeddings.projection")
    out["bert.embeddings.LayerNorm.weight"] = np.asarray(emb["norm"]["scale"])
    out["bert.embeddings.LayerNorm.bias"] = np.asarray(emb["norm"]["bias"])
    layers = trunk["encoder"]["layers"]
    for i in range(np.asarray(layers["attention_norm"]["scale"]).shape[0]):
        p = f"bert.encoder.layer.{i}."
        qk, qb = np.asarray(layers["attention"]["qkv"]["kernel"][i]), np.asarray(layers["attention"]["qkv"]["bias"][i])
        for j, name in enumerate(("query", "key", "value")):
            out[p + f"attention.self.{name}.weight"] = qk[:, j].reshape(H, nh * hd).T
            out[p + f"attention.self.{name}.bias"] = qb[j].reshape(nh * hd)
        out[p + "attention.output.dense.weight"] = np.asarray(layers["attention"]["out"]["kernel"][i]).reshape(
            nh * hd, H).T
        out[p + "attention.output.dense.bias"] = np.asarray(layers["attention"]["out"]["bias"][i])
        for flax, port in (("attention_norm", "attention.output.LayerNorm"), ("output_norm", "output.LayerNorm")):
            out[p + port + ".weight"] = np.asarray(layers[flax]["scale"][i])
            out[p + port + ".bias"] = np.asarray(layers[flax]["bias"][i])
        for flax, port in (("intermediate", "intermediate.dense"), ("output", "output.dense")):
            out[p + port + ".weight"] = np.asarray(layers[flax]["kernel"][i]).T
            out[p + port + ".bias"] = np.asarray(layers[flax]["bias"][i])
    dense(trunk["pooler"]["dense"], "bert.pooler.dense")
    if "cls" in tree:
        cls = tree["cls"]
        dense(cls["transform"]["dense"], "cls.predictions.transform.dense")
        out["cls.predictions.transform.LayerNorm.weight"] = np.asarray(cls["transform"]["norm"]["scale"])
        out["cls.predictions.transform.LayerNorm.bias"] = np.asarray(cls["transform"]["norm"]["bias"])
        out["cls.predictions.bias"] = np.asarray(cls["decoder_bias"])
        out["cls.predictions.decoder.weight"] = out["bert.embeddings.word_embeddings.weight"]
        if "seq_relationship" in cls:
            dense(cls["seq_relationship"], "cls.seq_relationship")
    if "classifier" in tree:
        dense(tree["classifier"]["dense"], "classifier")
    if "flickr_attention" in tree:
        for name in ("query", "key"):
            dense(tree["flickr_attention"][name], f"flickr_attention.{name}")
    return out


def convert_lxrt_state_dict(flat: Dict[str, np.ndarray], ucfg, dtype=np.float32) -> Dict:
    """The ``UnsupervisedVisualBert`` tree of a reference LXRT checkpoint
    (JAX ``convert_lxrt_state_dict``; reference ``src/lxrt/modeling.py``),
    the encoder stacked; only ``gamma``/``beta`` and ``module.`` are
    normalised (the HF aliases would mangle LXRT's MLM head); the tied
    decoders are dropped. A fine-tuned VQAModel's bare ``logit_fc`` lands in
    ``answer_head``."""
    def norm(k):
        return re.sub(r"\.beta$", ".bias", re.sub(r"\.gamma$", ".weight", re.sub(r"^module\.", "", k)))

    flat = {norm(k): np.asarray(v, dtype=dtype) for k, v in flat.items()}
    cfg = ucfg.bert
    H, nh, hd, L = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim, cfg.num_hidden_layers
    out: Dict = {}

    def linear(prefix, dst):
        if prefix + ".weight" in flat:
            _put(out, dst + ("kernel",), flat[prefix + ".weight"].T)
            _put(out, dst + ("bias",), flat[prefix + ".bias"])

    def lnorm(prefix, dst):
        if prefix + ".weight" in flat:
            _put(out, dst + ("scale",), flat[prefix + ".weight"])
            _put(out, dst + ("bias",), flat[prefix + ".bias"])

    E = "bert.embeddings."
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings", "symbolic_embedding"):
        if E + name + ".weight" in flat:
            _put(out, ("embeddings", name, "embedding"), flat[E + name + ".weight"])
    linear(E + "visn_fc", ("embeddings", "visn_fc"))
    linear(E + "box_fc", ("embeddings", "box_fc"))
    lnorm(E + "LayerNorm", ("embeddings", "text_norm"))
    lnorm(E + "visn_layer_norm", ("embeddings", "visn_norm"))
    lnorm(E + "box_layer_norm", ("embeddings", "box_norm"))
    lnorm(E + "tag_layer_norm", ("embeddings", "tag_norm"))

    if "bert.encoder.layer.0.attention.self.query.weight" in flat:
        stacks: Dict[tuple, list] = {}
        for i in range(L):
            pref = f"bert.encoder.layer.{i}"
            ws = [flat[f"{pref}.attention.self.{n}.weight"].T.reshape(H, nh, hd) for n in ("query", "key", "value")]
            bs = [flat[f"{pref}.attention.self.{n}.bias"].reshape(nh, hd) for n in ("query", "key", "value")]
            layer = {
                ("attention", "qkv", "kernel"): np.stack(ws, axis=1),
                ("attention", "qkv", "bias"): np.stack(bs, axis=0),
                ("attention", "out", "kernel"): flat[f"{pref}.attention.output.dense.weight"].T.reshape(nh, hd, H),
                ("attention", "out", "bias"): flat[f"{pref}.attention.output.dense.bias"],
                ("attention_norm", "scale"): flat[f"{pref}.attention.output.LayerNorm.weight"],
                ("attention_norm", "bias"): flat[f"{pref}.attention.output.LayerNorm.bias"],
                ("intermediate", "kernel"): flat[f"{pref}.intermediate.dense.weight"].T,
                ("intermediate", "bias"): flat[f"{pref}.intermediate.dense.bias"],
                ("output", "kernel"): flat[f"{pref}.output.dense.weight"].T,
                ("output", "bias"): flat[f"{pref}.output.dense.bias"],
                ("output_norm", "scale"): flat[f"{pref}.output.LayerNorm.weight"],
                ("output_norm", "bias"): flat[f"{pref}.output.LayerNorm.bias"],
            }
            for path, v in layer.items():
                stacks.setdefault(path, []).append(v)
        for path, vals in stacks.items():
            _put(out, ("encoder", "layers") + path, np.stack(vals, axis=0))

    linear("bert.pooler.dense", ("pooler", "dense"))
    linear("cls.predictions.transform.dense", ("mlm_transform", "dense"))
    lnorm("cls.predictions.transform.LayerNorm", ("mlm_transform", "norm"))
    if "cls.predictions.bias" in flat:
        _put(out, ("mlm_bias",), flat["cls.predictions.bias"])
    linear("cls.seq_relationship", ("seq_relationship",))
    linear("obj_predict_head.transform.dense", ("obj_head", "transform", "dense"))
    lnorm("obj_predict_head.transform.LayerNorm", ("obj_head", "transform", "norm"))
    for key in ("obj", "attr", "feat"):
        linear(f"obj_predict_head.decoder_dict.{key}", ("obj_head", key))
    linear("symbolic_head.predictions.transform.dense", ("tag_transform", "dense"))
    lnorm("symbolic_head.predictions.transform.LayerNorm", ("tag_transform", "norm"))
    if "symbolic_head.predictions.bias" in flat:
        _put(out, ("tag_bias",), flat["symbolic_head.predictions.bias"])
    for prefix in ("answer_head.logit_fc", "logit_fc"):  # fine-tuned VQAModel saves a bare logit_fc
        linear(f"{prefix}.0", ("answer_head", "fc1"))
        lnorm(f"{prefix}.2", ("answer_head", "norm"))
        linear(f"{prefix}.3", ("answer_head", "fc2"))
    return out


def convert_lxrt_for_vqa(flat: Dict[str, np.ndarray], ucfg, init_params: Dict, src_answers=None, dst_answers=None,
                         dtype=np.float32) -> Tuple[Dict, int]:
    """A pretrained LXRT checkpoint as an ``UnsupervisedVQAModel`` tree
    (``{"trunk": ..., "answer_head": ...}``, JAX ``convert_lxrt_for_vqa``,
    reference ``load_lxmert_qa``): the final answer layer's rows re-indexed
    by answer string from ``src_answers`` onto ``dst_answers`` over
    ``init_params["answer_head"]["fc2"]`` (unmatched rows keep their init);
    without both tables the final layer is dropped. Returns (partial tree,
    answers copied); merge the tree with :func:`merge_into`."""
    from visualbert_torch.data.answer_table import AnswerTable, remap_answer_head

    tree = convert_lxrt_state_dict(flat, ucfg, dtype=dtype)
    answer = tree.pop("answer_head", None)
    out: Dict = {"trunk": tree}
    if answer is None:
        return out, 0
    if src_answers is None or dst_answers is None:
        answer.pop("fc2", None)
        out["answer_head"] = answer
        return out, 0
    src = src_answers if isinstance(src_answers, AnswerTable) else AnswerTable(src_answers)
    dst = dst_answers if isinstance(dst_answers, AnswerTable) else AnswerTable(dst_answers)
    init_fc2 = init_params["answer_head"]["fc2"]
    remapped = remap_answer_head(kernel=answer["fc2"]["kernel"], bias=answer["fc2"]["bias"], src_table=src,
                                 dst_table=dst, dst_kernel=np.asarray(init_fc2["kernel"]),
                                 dst_bias=np.asarray(init_fc2["bias"]))
    answer["fc2"] = {"kernel": remapped["kernel"], "bias": remapped["bias"]}
    out["answer_head"] = answer
    return out, remapped["n_copied"]


_RESNET_STAGE_BLOCKS = {"layer1": 3, "layer2": 4, "layer3": 6, "layer4": 3}

# the reference wraps the torchvision modules in nn.Sequential containers,
# renaming them positionally (detector.py:62-70, 87-93, 95-99)
_DETECTOR_SEQ_ALIASES = [
    (r"^backbone\.0\.", "conv1."),
    (r"^backbone\.1\.", "bn1."),
    (r"^backbone\.4\.", "layer1."),
    (r"^backbone\.5\.", "layer2."),
    (r"^backbone\.6\.", "layer3."),
    (r"^after_roi_align\.0\.", "layer4."),
    (r"^obj_downsample\.1\.", "obj_downsample."),
    (r"^module\.", ""),
    (r"^detector\.", ""),
]


def convert_resnet50_state_dict(flat: Dict[str, np.ndarray], dtype=np.float32) -> Dict:
    """The Flax ``SimpleDetector`` tree of a torchvision-format ResNet50
    state dict or a reference ``SimpleDetector`` checkpoint (its Sequential
    names, detector.py:62-70), as JAX ``convert_resnet50_state_dict`` with
    the 7 x 7 stem: conv [O, I, kh, kw] -> [kh, kw, I, O], batch norm
    weight/bias/running_mean/running_var -> scale/bias/mean/var, linear
    [O, I] -> kernel [I, O]. The stride surgery changes no shape."""
    renamed = {}
    for k, v in flat.items():
        for pat, rep in _DETECTOR_SEQ_ALIASES:
            k = re.sub(pat, rep, k)
        renamed[k] = np.asarray(v, dtype=dtype)
    flat = renamed
    out: Dict = {}

    def conv(prefix, dst):
        w = flat.get(prefix + ".weight")
        if w is None:
            return False
        _put(out, dst + ("kernel",), np.transpose(w, (2, 3, 1, 0)))
        if prefix + ".bias" in flat:
            _put(out, dst + ("bias",), flat[prefix + ".bias"])
        return True

    def bn(prefix, dst):
        if prefix + ".weight" in flat:
            for src, leaf in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")):
                _put(out, dst + (leaf,), flat[f"{prefix}.{src}"])

    conv("conv1", ("backbone", "conv1"))
    bn("bn1", ("backbone", "bn1"))
    for stage, blocks in _RESNET_STAGE_BLOCKS.items():
        root = ("after_roi_align", "layer4") if stage == "layer4" else ("backbone", stage)
        for i in range(blocks):
            blk, pref = root + (f"block{i}",), f"{stage}.{i}"
            if not conv(f"{pref}.conv1", blk + ("conv1",)):
                continue
            for j in (1, 2, 3):
                conv(f"{pref}.conv{j}", blk + (f"conv{j}",))
                bn(f"{pref}.bn{j}", blk + (f"bn{j}",))
            conv(f"{pref}.downsample.0", blk + ("downsample_conv",))
            bn(f"{pref}.downsample.1", blk + ("downsample_bn",))
    conv("mask_upsample", ("mask_upsample",))
    if "object_embed.weight" in flat:
        _put(out, ("object_embed", "embedding"), flat["object_embed.weight"])
    for name in ("regularizing_predictor", "obj_downsample"):
        if name + ".weight" in flat:
            _put(out, (name, "kernel"), flat[name + ".weight"].T)
            _put(out, (name, "bias"), flat[name + ".bias"])
    return out


def resnet50_state(tree: Dict) -> Dict[str, np.ndarray]:
    """The inverse of :func:`convert_resnet50_state_dict`: a Flax
    ``SimpleDetector`` tree (7 x 7 stem) as torchvision keys (the port's
    copy of JAX ``export_resnet50_state_dict``)."""
    out: Dict[str, np.ndarray] = {}

    def conv(src, prefix):
        out[prefix + ".weight"] = np.transpose(np.asarray(src["kernel"]), (3, 2, 0, 1))
        if "bias" in src:
            out[prefix + ".bias"] = np.asarray(src["bias"])

    def bn(src, prefix):
        for leaf, key in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")):
            out[f"{prefix}.{leaf}"] = np.asarray(src[key])

    bb = tree["backbone"]
    conv(bb["conv1"], "conv1")
    bn(bb["bn1"], "bn1")
    for stage in _RESNET_STAGE_BLOCKS:
        root = tree["after_roi_align"]["layer4"] if stage == "layer4" else bb[stage]
        for name, blk in root.items():
            pref = f"{stage}.{int(name[len('block'):])}"
            for j in (1, 2, 3):
                conv(blk[f"conv{j}"], f"{pref}.conv{j}")
                bn(blk[f"bn{j}"], f"{pref}.bn{j}")
            if "downsample_conv" in blk:
                conv(blk["downsample_conv"], f"{pref}.downsample.0")
                bn(blk["downsample_bn"], f"{pref}.downsample.1")
    if "mask_upsample" in tree:
        conv(tree["mask_upsample"], "mask_upsample")
    if "object_embed" in tree:
        out["object_embed.weight"] = np.asarray(tree["object_embed"]["embedding"])
    for name in ("regularizing_predictor", "obj_downsample"):
        if name in tree:
            out[name + ".weight"] = np.asarray(tree[name]["kernel"]).T
            out[name + ".bias"] = np.asarray(tree[name]["bias"])
    return out


def maybe_special_initialize(params: Dict) -> Dict:
    """Copy the text token-type and position tables into the visual ones
    when the file lacks them (reference ``special_intialize``,
    modeling.py:1191-1196)."""
    emb = params.get("bert", {}).get("embeddings", {})
    for text, visual in (("token_type_embeddings", "token_type_embeddings_visual"),
                         ("position_embeddings", "position_embeddings_visual")):
        if text in emb and visual not in emb:
            emb[visual] = {"embedding": np.array(emb[text]["embedding"])}
    return params


def merge_into(init: Dict, loaded: Dict, strict: bool = False) -> Tuple[Dict, List[tuple]]:
    """``loaded`` (possibly partial) over ``init``, both nested dicts of
    arrays: (a new tree with init's leaves replaced where ``loaded`` has
    them, the replaced paths). Shapes must agree; keys of ``loaded`` that
    ``init`` lacks are skipped, or raise with ``strict``."""
    replaced: List[tuple] = []

    def walk(init_node, loaded_node, path):
        if not isinstance(loaded_node, dict):
            if tuple(np.shape(init_node)) != tuple(np.shape(loaded_node)):
                raise ValueError(f"shape mismatch at {path}: {np.shape(init_node)} vs {np.shape(loaded_node)}")
            replaced.append(path)
            return np.asarray(loaded_node, dtype=np.asarray(init_node).dtype)
        out = dict(init_node)
        for k, v in loaded_node.items():
            if k not in init_node:
                if strict:
                    raise KeyError(f"unexpected key {path + (k,)}")
                continue
            out[k] = walk(init_node[k], v, path + (k,))
        return out

    return walk(init, loaded, ()), replaced


def _sub(state: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def model_tree(model) -> Dict:
    """The model's parameters as the JAX package's tree of the same model:
    ``VisualBertForTask`` through :func:`convert_state_dict`,
    ``VisualBertDetectorModel`` as ``{"bert": ..., "detector": ...}``,
    ``UnsupervisedVisualBert`` through :func:`convert_lxrt_state_dict` and
    ``UnsupervisedVQAModel`` as ``{"trunk": ..., "answer_head": ...}``."""
    from visualbert_torch.models.unsupervised import UnsupervisedVisualBert, UnsupervisedVQAModel
    from visualbert_torch.models.vcr import VisualBertDetectorModel
    from visualbert_torch.models.visualbert import VisualBertForTask

    state = {k: v.detach().cpu().float().numpy() for k, v in model.state_dict().items()}
    if isinstance(model, VisualBertForTask):
        return convert_state_dict(state, model.cfg)
    if isinstance(model, VisualBertDetectorModel):
        return {"bert": convert_state_dict(_sub(state, "bert."), model.bert.cfg),
                "detector": convert_resnet50_state_dict(_sub(state, "detector."))}
    if isinstance(model, UnsupervisedVisualBert):
        tree = convert_lxrt_state_dict(state, model.ucfg)
        if isinstance(model, UnsupervisedVQAModel):
            tree = {"answer_head": tree.pop("answer_head"), "trunk": tree}
        return tree
    raise TypeError(f"no Flax layout for {type(model).__name__}")


def load_tree(model, tree: Dict) -> None:
    """Write a whole tree in :func:`model_tree`'s layout back into the
    model (strict: every parameter)."""
    from visualbert_torch.models.unsupervised import UnsupervisedVisualBert
    from visualbert_torch.models.vcr import VisualBertDetectorModel
    from visualbert_torch.tools.weights import detector_model_state, load_state

    if isinstance(model, VisualBertDetectorModel):
        state = detector_model_state(task_state(tree["bert"], model.bert.cfg), resnet50_state(tree["detector"]))
    elif isinstance(model, UnsupervisedVisualBert):
        state = unsupervised_state(tree)
    else:
        state = task_state(tree, model.cfg)
    load_state(model, state)


def restore_torch_file(model, path: str, cfg) -> List[tuple]:
    """Load a reference checkpoint into ``model`` as the JAX registry's
    ``_restore`` loads it into its params: ``convert_state_dict`` under the
    task's model config ``cfg``, ``maybe_special_initialize``, then a
    non-strict ``merge_into`` over the model's own tree. Returns the Flax
    paths that were loaded; every other parameter keeps its value."""
    loaded = maybe_special_initialize(convert_state_dict(load_torch_file(path), cfg))
    merged, replaced = merge_into(model_tree(model), loaded)
    if replaced:
        load_tree(model, merged)
    return replaced

"""End-to-end unsupervised pretraining: the detector inside the training
graph, feeding the three-stream encoder (counterpart of
``visualbert_tpu/models/unsup_e2e.py``; BASELINE.json config 5).

Images and proposal boxes go through ``SimpleDetector`` (ResNet50, RoIAlign,
layer4; ``semantic=False``) to 2048-d object features, which become the
region stream of ``UnsupervisedVisualBert``. The masked-feature and
masked-tag objectives are built in the graph from the detector's own
outputs:

  * region features = the detector's ``obj_reps_raw`` in fp32, zeroed where
    the host-drawn ``feat_mask`` is set; the regression target is the
    unmasked features, detached;
  * tags = the detector's class predictions (argmax of its 81 logits)
    mapped into the symbolic vocabulary (``class_to_symbolic``, else
    clipped to it), replaced by [MASK] where ``tag_mask`` is set; the
    masked-tag objective predicts the detached tag.

The detector's ``obj_downsample`` head (``final_dim`` 512) is built, as the
JAX tree holds it, but no loss reaches it: BertAdam sees a zero gradient and
still decays it, as JAX does.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from visualbert_torch.models.detector import SimpleDetector
from visualbert_torch.models.unsupervised import (UnsupervisedConfig, UnsupervisedVisualBert, flax_decays,
                                                  flax_path)

_TEXT_KEYS = ("input_ids", "token_type_ids", "input_mask", "masked_lm_labels", "matched_label", "ans")


class UnsupervisedEndToEnd(nn.Module):
    """``detector`` (SimpleDetector, semantic off, final_dim 512) +
    ``trunk`` (UnsupervisedVisualBert). Forward takes a batch dict and an
    optional dropout generator (dropout on iff given), so ``Trainer`` drives
    it unchanged.

    Batch keys: ``images`` [B, H, W, 3] (uint8 or normalized fp32),
    ``boxes`` [B, N, 4] (pixels), ``boxes_norm`` [B, N, 4] (0-1, for the box
    embeddings), ``box_mask`` [B, N], ``feat_mask`` and ``tag_mask`` [B, N]
    {0, 1} (host-drawn), and optionally ``input_ids``, ``token_type_ids``,
    ``input_mask``, ``masked_lm_labels``, ``matched_label`` and ``ans``.
    The output is the trunk's, with ``cnn_aux_loss`` (the detector's
    ``cnn_regularization_loss``: None, since the detector sees no classes)."""

    def __init__(self, ucfg: UnsupervisedConfig, class_to_symbolic: Tuple[int, ...] = (), train_detector: bool = True,
                 trunk_blocks=(3, 4, 6), layer4_blocks: int = 3, width_div: int = 1):
        super().__init__()
        self.ucfg = ucfg
        self.class_to_symbolic = tuple(class_to_symbolic)
        self.train_detector = train_detector
        self.detector = SimpleDetector(final_dim=512, semantic=False, dtype=ucfg.bert.dtype,
                                       trunk_blocks=tuple(trunk_blocks), layer4_blocks=layer4_blocks,
                                       width_div=width_div)
        self.trunk = UnsupervisedVisualBert(ucfg)

    def init_weights(self, generator: torch.Generator) -> "UnsupervisedEndToEnd":
        self.detector.init_weights(generator)
        self.trunk.init_weights(generator)
        return self

    def decays(self, name: str, no_decay: Iterable[str] = ()) -> bool:
        """JAX's weight-decay decision on the parameter's Flax path: the
        trunk's under ``trunk/`` (``flax_path``), the detector's under
        ``detector/`` (:func:`detector_flax_path`); FrozenBN scales and
        biases take none, their means and vars do (ROADMAP.md C8)."""
        module, rest = name.split(".", 1)
        path = flax_path(rest) if module == "trunk" else detector_flax_path(rest)
        return flax_decays(f"{module}/{path}", no_decay)

    def forward(self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
                output_attention_probs: bool = False):
        ucfg = self.ucfg
        det = self.detector(batch["images"], batch["boxes"], batch["box_mask"], generator=generator)
        feats = det["obj_reps_raw"].float()  # [B, N, 2048]
        if not self.train_detector:
            feats = feats.detach()
        pred_classes = det["obj_logits"].argmax(dim=-1)  # [B, N]
        if self.class_to_symbolic:
            table = torch.tensor(self.class_to_symbolic, dtype=torch.long, device=pred_classes.device)
            tags_clean = table[pred_classes]
        else:
            tags_clean = pred_classes.clamp_max(ucfg.symbolic_vocab_size - 1)

        feat_mask = batch["feat_mask"].float()
        tag_mask, box_mask = batch["tag_mask"], batch["box_mask"]
        mask_sym = ucfg.obj_id_num + ucfg.attr_id_num + 2  # the symbolic [MASK]
        minus_one = torch.full_like(pred_classes, -1)
        sub = {
            "visual_feats": feats * (1.0 - feat_mask)[..., None],
            "boxes": batch["boxes_norm"],
            "visual_feats_mask": box_mask,
            "visual_tags": torch.where(tag_mask > 0, torch.full_like(tags_clean, mask_sym), tags_clean),
            "visual_tags_box": batch["boxes_norm"],
            "visual_tags_mask": box_mask,
            # the targets are the detector's own outputs, detached
            "feat_target": feats.detach(),
            "feat_mask": feat_mask * box_mask,
            "obj_labels": torch.where((feat_mask > 0) & (box_mask > 0), pred_classes, minus_one),
            "obj_conf": feat_mask * box_mask,
            "attr_labels": minus_one,  # no attributes
            "attr_conf": torch.zeros_like(feat_mask),
            "visual_tags_objective": torch.where((tag_mask > 0) & (box_mask > 0), tags_clean, minus_one),
        }
        sub.update((k, batch[k]) for k in _TEXT_KEYS if batch.get(k) is not None)
        out = self.trunk(sub, generator, output_attention_probs)
        out["cnn_aux_loss"] = det.get("cnn_regularization_loss")
        return out


_STAGE = re.compile(r"layer(\d)\.(\d+)\.(.+)")
_BN_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def detector_flax_path(name: str) -> str:
    """The '/'-joined path in the JAX ``SimpleDetector`` tree of the port's
    detector parameter ``name`` (a torchvision key, the inverse of
    ``export_resnet50_state_dict``): ``conv1.weight`` ->
    ``backbone/conv1/kernel``, ``layer4.0.downsample.1.running_var`` ->
    ``after_roi_align/layer4/block0/downsample_bn/var``."""
    module, leaf = name.rsplit(".", 1)
    m = _STAGE.fullmatch(module)
    if m:
        stage, block, part = m.groups()
        part = {"downsample.0": "downsample_conv", "downsample.1": "downsample_bn"}.get(part, part)
        root = "after_roi_align/layer4" if stage == "4" else f"backbone/layer{stage}"
        module = f"{root}/block{block}/{part}"
    elif module in ("conv1", "bn1"):
        module = "backbone/" + module
    if module.rsplit("/", 1)[-1].startswith(("bn", "downsample_bn")):
        return f"{module}/{_BN_LEAVES[leaf]}"
    if module.endswith("object_embed"):
        return f"{module}/embedding"
    return f"{module}/{'kernel' if leaf == 'weight' else leaf}"

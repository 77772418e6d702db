"""The detector of the VCR path: ResNet50 trunk + RoIAlign + a per-box head
(counterpart of ``visualbert_tpu/models/detector.py``; reference
``SimpleDetector``, ``visualbert/utils/detector.py:48-144``).

* ResNet50 through layer3 with the tf-faster-rcnn stride surgery: layers 2
  and 3 carry their stride on conv1, not conv2, and layer4 has stride 1
  (detector.py:30-45), so the trunk's output stride is 16, 1024 channels.
* RoIAlign 7 x 7 at 1/16 (``ops/roi_align.py``) over every padded box.
* The segmentation-mask injection: a 3 x 3 stride-2 conv of the 14 x 14 soft
  mask added to the first 32 RoI channels (detector.py:122-125).
* layer4 and a mean pool a box -> 2048-d (detector.py:126-127).
* An 81-way auxiliary classifier -> ``cnn_regularization_loss``, a masked
  CE over the real boxes (detector.py:128-131).
* The class embedding concatenated, dropout, a linear layer and ReLU ->
  ``final_dim`` (detector.py:92-96, 133-136).

Layout: images arrive NHWC from the datasets (uint8 or fp32) and the trunk
runs NCHW. Convolutions run in ``dtype`` through ``F.conv2d``; the JAX
package runs them in XLA, so they are modules, not kernels to port. The
stem is the 7 x 7 stride-2 conv: the JAX trunk's space-to-depth stem is a
TPU layout of the same 147-tap conv, and ``export_resnet50_state_dict``
writes it back as the 7 x 7 kernel.

``FrozenBatchNorm`` keeps the JAX module's four vectors as parameters
(``weight``, ``bias``, ``running_mean``, ``running_var``): the JAX package
declares them as Flax params, so gradients reach them and BertAdam updates
them unless ``optimizer.frozen`` names them (ROADMAP.md C8); the reference
freezes them. The port follows the JAX package.

Parameter names are the torchvision keys that
``visualbert_tpu/tools/export_torch.py::export_resnet50_state_dict`` emits:
``conv1``, ``bn1``, ``layerK.i.{convJ,bnJ,downsample.{0,1}}``,
``mask_upsample``, ``object_embed``, ``regularizing_predictor`` and
``obj_downsample``, so a Flax detector loads with ``strict=True``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from visualbert_torch.models import losses
from visualbert_torch.models.encoder import _TRUNC_STD, linear, seeded_dropout
from visualbert_torch.ops.roi_align import roi_align
from visualbert_torch.utils.images import IMAGENET_MEAN, IMAGENET_STD


class FrozenBatchNorm(nn.Module):
    """BatchNorm with stored statistics, applied in fp32:
    ``x * inv + (bias - mean * inv)``, ``inv = rsqrt(var + eps) * weight``,
    cast back to ``dtype`` (JAX ``detector.py:38-53``)."""

    def __init__(self, features: int, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.running_mean = nn.Parameter(torch.zeros(features))
        self.running_var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W]
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * inv
        return (x.float() * inv[:, None, None] + shift[:, None, None]).to(self.dtype)


def conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """``nn.Conv(dtype=dtype)``: input, weight and bias in the compute dtype."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, layer.stride, layer.padding)


class Bottleneck(nn.Module):
    """ResNet bottleneck; the stride sits on conv1 when ``stride_on_conv1``
    (the surgery's layers 2-4), else on conv2."""

    def __init__(self, cin: int, features: int, stride: int, stride_on_conv1: bool, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        s1, s2 = (stride, 1) if stride_on_conv1 else (1, stride)
        self.conv1 = nn.Conv2d(cin, features, 1, stride=s1, bias=False)
        self.bn1 = FrozenBatchNorm(features, dtype)
        self.conv2 = nn.Conv2d(features, features, 3, stride=s2, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm(features, dtype)
        self.conv3 = nn.Conv2d(features, features * 4, 1, bias=False)
        self.bn3 = FrozenBatchNorm(features * 4, dtype)
        if cin != features * 4 or stride != 1:
            self.downsample = nn.Sequential(nn.Conv2d(cin, features * 4, 1, stride=stride, bias=False),
                                            FrozenBatchNorm(features * 4, dtype))
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        y = F.relu(self.bn1(conv(x, self.conv1, d)))
        y = F.relu(self.bn2(conv(y, self.conv2, d)))
        y = self.bn3(conv(y, self.conv3, d))
        residual = x if self.downsample is None else self.downsample[1](conv(x, self.downsample[0], d))
        return F.relu(y + residual)


def resnet_stage(cin: int, features: int, blocks: int, stride: int, stride_on_conv1: bool,
                 dtype: torch.dtype) -> nn.Sequential:
    """``blocks`` bottlenecks, the first with the stride (JAX ``ResNetStage``)."""
    return nn.Sequential(*(
        Bottleneck(cin if i == 0 else features * 4, features, stride if i == 0 else 1,
                   stride_on_conv1 and i == 0, dtype)
        for i in range(blocks)))


class ResNet50Trunk(nn.Module):
    """conv1 .. layer3: [B, 3, H, W] -> [B, 1024/div, H/16, W/16].

    ``blocks`` is the bottleneck count of layers 1-3 ((3, 4, 6) is
    ResNet50, the reference's backbone); ``width_div`` divides every width
    (tests)."""

    def __init__(self, dtype: torch.dtype, blocks=(3, 4, 6), width_div: int = 1):
        super().__init__()
        self.dtype = dtype
        d = width_div
        self.conv1 = nn.Conv2d(3, 64 // d, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64 // d, dtype)
        self.layer1 = resnet_stage(64 // d, 64 // d, blocks[0], 1, False, dtype)
        self.layer2 = resnet_stage(256 // d, 128 // d, blocks[1], 2, True, dtype)
        self.layer3 = resnet_stage(512 // d, 256 // d, blocks[2], 2, True, dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.trunk(images)

    def trunk(self, images: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(conv(images, self.conv1, self.dtype)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        return self.layer3(self.layer2(self.layer1(x)))


def resnet50_layer4(dtype: torch.dtype, blocks: int = 3, width_div: int = 1) -> nn.Sequential:
    """layer4 at stride 1, the post-RoI head: [N, 1024/div, 7, 7] ->
    [N, 2048/div, 7, 7] (JAX ``ResNet50Layer4``)."""
    return resnet_stage(1024 // width_div, 512 // width_div, blocks, 1, True, dtype)


class SimpleDetector(ResNet50Trunk):
    """The detector: per-box representations of an image's boxes. The
    trunk's modules are the detector's own, so its parameter names are the
    torchvision keys. ``semantic`` adds the mask injection and the class
    embedding (and their parameters), and needs ``classes``."""

    mesh = None

    def __init__(self, final_dim: int = 512, semantic: bool = True, num_classes: int = 81, mask_dims: int = 32,
                 dtype: torch.dtype = torch.bfloat16, dropout_rate: float = 0.1, trunk_blocks=(3, 4, 6),
                 layer4_blocks: int = 3, width_div: int = 1):
        super().__init__(dtype, trunk_blocks, width_div)
        self.final_dim = final_dim
        self.semantic = semantic
        self.mask_dims = mask_dims
        self.dropout_rate = dropout_rate
        self.layer4 = resnet50_layer4(dtype, layer4_blocks, width_div)
        width = 2048 // width_div
        if semantic:
            self.mask_upsample = nn.Conv2d(1, mask_dims, 3, stride=2, padding=1)
            self.object_embed = nn.Embedding(num_classes, 128)
        self.regularizing_predictor = nn.Linear(width, num_classes)
        self.obj_downsample = nn.Linear(width + (128 if semantic else 0), final_dim)

    def init_weights(self, generator: torch.Generator) -> "SimpleDetector":
        """Flax's defaults, seeded: convolution and dense kernels truncated
        normal with variance 1 / fan_in (``lecun_normal``), the class table
        1 / num_classes, zero biases, identity batch norms. Modules are
        visited in registration order, so a seed fixes the weights."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.Linear, nn.Embedding)):
                    fan_in = m.weight.shape[0] if isinstance(m, nn.Embedding) else m.weight[0].numel()
                    std = 1.0 / math.sqrt(fan_in) / _TRUNC_STD
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                    if getattr(m, "bias", None) is not None:
                        m.bias.zero_()
                elif isinstance(m, FrozenBatchNorm):
                    m.weight.fill_(1.0), m.bias.zero_(), m.running_mean.zero_(), m.running_var.fill_(1.0)
        return self

    def forward(self, images: torch.Tensor, boxes: torch.Tensor, box_mask: torch.Tensor,
                classes: Optional[torch.Tensor] = None, segms: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                image_hw: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """images [B, H, W, 3] uint8 or normalized fp32, boxes [B, N, 4]
        (x1, y1, x2, y2) pixels, box_mask [B, N], classes [B, N], segms
        [B, N, 14, 14], image_hw [B, 2] the content extent inside the
        canvas. Dropout is on iff a generator is given. Returns
        ``obj_reps`` [B, N, final_dim], ``obj_reps_raw`` [B, N, 2048],
        ``obj_logits`` [B, N, 81] fp32 and, with classes,
        ``cnn_regularization_loss``."""
        B, N = boxes.shape[:2]
        dt = self.dtype
        if images.dtype == torch.uint8:
            # the uint8 wire format: normalize on the device and zero the
            # square padding outside the content, as the host-normalized
            # canvas is (reference box_utils.py:56-63)
            mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
            std = torch.as_tensor(IMAGENET_STD, device=images.device)
            images = (images.float() / 255.0 - mean) / std
            if image_hw is not None:
                H, W = images.shape[1], images.shape[2]
                in_h = torch.arange(H, device=images.device)[None, :] < image_hw[:, :1]  # [B, H]
                in_w = torch.arange(W, device=images.device)[None, :] < image_hw[:, 1:2]  # [B, W]
                images = images * (in_h[:, :, None] & in_w[:, None, :])[..., None].to(images.dtype)
        img_h, img_w = images.shape[1], images.shape[2]
        fm = self.trunk(images.permute(0, 3, 1, 2).to(dt))
        # clip the boxes to the image, so every RoI lies inside the feature
        # map, where roi_align's quadrature is torchvision's
        lim = torch.tensor([img_w - 1, img_h - 1, img_w - 1, img_h - 1], dtype=boxes.dtype, device=boxes.device)
        boxes = torch.minimum(boxes.clamp_min(0), lim)
        roi = roi_align(fm, boxes, out_size=7, sampling_ratio=0, spatial_scale=1 / 16)
        roi = roi.reshape(B * N, fm.shape[1], 7, 7)
        if self.semantic and segms is not None:
            m = conv(segms.reshape(B * N, 1, 14, 14).to(dt) - 0.5, self.mask_upsample, dt)
            roi = torch.cat([roi[:, : self.mask_dims] + m, roi[:, self.mask_dims:]], dim=1)
        post = self.layer4(roi).mean(dim=(2, 3))  # [B*N, 2048] global average pool
        obj_logits = linear(post, self.regularizing_predictor, dt).float()
        out = {"obj_reps_raw": post.reshape(B, N, -1), "obj_logits": obj_logits.reshape(B, N, -1)}
        feats = post
        if self.semantic:
            if classes is None:
                raise ValueError("a semantic SimpleDetector needs the boxes' classes")
            labels = classes.reshape(B * N).long()
            feats = torch.cat([post, self.object_embed(labels).to(dt)], dim=-1)
            # masked CE over the real boxes (detector.py:128-131)
            ce = -torch.log_softmax(obj_logits, dim=-1).gather(1, labels[:, None])[:, 0]
            valid = box_mask.reshape(-1).float()
            out["cnn_regularization_loss"] = (ce * valid).sum() / losses.denominator(valid.sum()).clamp_min(1.0)
        feats = seeded_dropout(feats, self.dropout_rate, generator, self.mesh)
        out["obj_reps"] = F.relu(linear(feats, self.obj_downsample, dt)).reshape(B, N, self.final_dim)
        return out

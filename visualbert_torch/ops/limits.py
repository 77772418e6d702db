"""What the CUDA kernels take, checked where a model meets its device.

A config that selects a kernel (``use_flash_attention``, ``fused_mlm_xent``,
``use_fused_layer_norm``, ``fast_dropout``) with a dtype or width the kernel
cannot take would otherwise raise at the first step on the card. The JAX kernels take
any of them. :func:`check_kernel_limits` refuses such a config before the
first step, naming the limit and the flag:

* attention (K1/K2, K11/K12, K13/K14): bf16, head dim 64;
* the fused MLM cross-entropy (K4-K6): bf16, hidden width 768 or 1024;
* the residual LayerNorm (K7-K10): hidden width a multiple of 8 up to 1024
  (bf16, fp16 or fp32);
* the dropout site (``fast_dropout``, K3's body): bf16, fp16 or fp32, any
  shape; its tensors must start on a 16-byte boundary, which every site's
  freshly allocated activation does, and the wrapper refuses one that does
  not when it is called.

On the CPU every flag runs its plain version, which takes any dtype and
width, so nothing is checked there. The sequence length is checked when a
kernel is called: the data, not the config, sets it.
"""

from __future__ import annotations

import torch

from visualbert_torch.ops.dropout import ALIGNMENT, SITE_DTYPES
from visualbert_torch.ops.flash_attention import KERNEL_HEAD_DIM
from visualbert_torch.ops.mlm_xent import KERNEL_WIDTHS

LAYER_NORM_MAX_WIDTH = 1024  # csrc/layer_norm.cu: 32 lanes x 8 elements x MAX_CHUNKS


def check_kernel_limits(cfg, device) -> None:
    """Raise ValueError on a CUDA ``device`` when a kernel flag of the model
    config ``cfg`` selects a kernel that cannot take its dtype or widths;
    the message names each limit and flag."""
    if torch.device(device).type != "cuda":
        return
    problems = []
    if cfg.use_flash_attention:
        if cfg.dtype != torch.bfloat16:
            problems.append(f"use_flash_attention: the attention kernels take bf16 only, the config's dtype is "
                            f"{cfg.dtype}")
        if cfg.hidden_size % cfg.num_attention_heads or cfg.head_dim != KERNEL_HEAD_DIM:
            problems.append(f"use_flash_attention: the attention kernels take head dim {KERNEL_HEAD_DIM}, the "
                            f"config has hidden_size {cfg.hidden_size} over {cfg.num_attention_heads} heads")
    if cfg.fused_mlm_xent:
        if cfg.dtype != torch.bfloat16:
            problems.append(f"fused_mlm_xent: the cross-entropy kernels take bf16 only, the config's dtype is "
                            f"{cfg.dtype}")
        if cfg.hidden_size not in KERNEL_WIDTHS:
            problems.append(f"fused_mlm_xent: the cross-entropy kernels take hidden width "
                            f"{' or '.join(map(str, KERNEL_WIDTHS))}, the config has {cfg.hidden_size}")
    if cfg.use_fused_layer_norm and (cfg.hidden_size % 8 or cfg.hidden_size > LAYER_NORM_MAX_WIDTH):
        problems.append(f"use_fused_layer_norm: the LayerNorm kernels take a hidden width that is a multiple of 8 "
                        f"up to {LAYER_NORM_MAX_WIDTH}, the config has {cfg.hidden_size}")
    if cfg.fast_dropout and cfg.dtype not in SITE_DTYPES:
        problems.append(f"fast_dropout: the dropout site kernels take bf16, fp16 or fp32 tensors on a "
                        f"{ALIGNMENT}-byte boundary, the config's dtype is {cfg.dtype}")
    if problems:
        raise ValueError("the config selects CUDA kernels outside their limits: " + "; ".join(problems))

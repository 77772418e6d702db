"""What the CUDA kernels take, checked where a model meets its device.

A config that selects a kernel (``use_flash_attention``, ``fused_mlm_xent``,
``use_fused_layer_norm``, ``fast_dropout``) with a dtype or width the kernel
cannot take would otherwise raise at the first step on the card. The JAX kernels take
any of them. :func:`check_kernel_limits` refuses such a config before the
first step, naming the limit and the flag:

* the packed attention (K1/K2, ``use_flash_attention`` as shipped): bf16,
  fp16 or fp32, head dim up to 128 (bf16 and fp16 on kernels built at head
  dims 64 and 128, a smaller head dim zero-padded to the next; fp32 on its
  own kernels at any head dim);
* the heads-major and save-probs attention (K11/K12 with ``packed_qkv``
  false, K13/K14 with ``flash_save_probs``): bf16, head dim 64;
* the fused MLM cross-entropy (K4-K6): bf16, fp16 or fp32, hidden width up
  to 1024 (bf16 and fp16 on kernels built at 128, 256, 512, 768 and 1024,
  another width zero-padded to the next; fp32 on its own kernels);
* the residual LayerNorm (K7-K10): hidden width a multiple of 8 up to 1024
  (bf16, fp16 or fp32);
* the dropout site (``fast_dropout``, K3's body): bf16, fp16 or fp32, any
  shape; its tensors must start on a 16-byte boundary, which every site's
  freshly allocated activation does, and the wrapper refuses one that does
  not when it is called.

On the CPU every flag runs its plain version, which takes any dtype and
width, so nothing is checked there. The sequence length is checked when a
kernel is called: the data, not the config, sets it (K1/K2 at head dims
above 64 run on the kernels built at 128, whose shared memory limits T to
about half of what 64 takes; the wrapper names the limit).
"""

from __future__ import annotations

import torch

from visualbert_torch.ops.dropout import ALIGNMENT, SITE_DTYPES
from visualbert_torch.ops.flash_attention import KERNEL_HEAD_DIM, MAX_HEAD_DIM, PACKED_DTYPES
from visualbert_torch.ops.mlm_xent import KERNEL_DTYPES, MAX_WIDTH

LAYER_NORM_MAX_WIDTH = 1024  # csrc/layer_norm.cu: 32 lanes x 8 elements x MAX_CHUNKS


def _attention_problems(cfg) -> list:
    if cfg.hidden_size % cfg.num_attention_heads:
        return [f"use_flash_attention: hidden_size {cfg.hidden_size} does not divide by "
                f"{cfg.num_attention_heads} heads"]
    if not cfg.packed_qkv or cfg.flash_save_probs:
        which = ("heads-major kernels (K11/K12, packed_qkv false)" if not cfg.packed_qkv
                 else "save-probs kernels (K13/K14, flash_save_probs)")
        if cfg.dtype != torch.bfloat16 or cfg.head_dim != KERNEL_HEAD_DIM:
            return [f"use_flash_attention: the {which} take bf16 at head dim {KERNEL_HEAD_DIM} only, the config "
                    f"has {cfg.dtype} and head dim {cfg.head_dim}"]
        return []
    problems = []
    if cfg.dtype not in PACKED_DTYPES:
        problems.append(f"use_flash_attention: the packed attention kernels take bf16, fp16 or fp32, the "
                        f"config's dtype is {cfg.dtype}")
    if cfg.head_dim > MAX_HEAD_DIM:
        problems.append(f"use_flash_attention: the packed attention kernels take head dims up to {MAX_HEAD_DIM}, "
                        f"the config has hidden_size {cfg.hidden_size} over {cfg.num_attention_heads} heads")
    return problems


def check_kernel_limits(cfg, device) -> None:
    """Raise ValueError on a CUDA ``device`` when a kernel flag of the model
    config ``cfg`` selects a kernel that cannot take its dtype or widths;
    the message names each limit and flag."""
    if torch.device(device).type != "cuda":
        return
    problems = []
    if cfg.use_flash_attention:
        problems += _attention_problems(cfg)
    if cfg.fused_mlm_xent:
        if cfg.dtype not in KERNEL_DTYPES:
            problems.append(f"fused_mlm_xent: the cross-entropy kernels take bf16, fp16 or fp32, the config's "
                            f"dtype is {cfg.dtype}")
        if cfg.hidden_size > MAX_WIDTH:
            problems.append(f"fused_mlm_xent: the cross-entropy kernels take hidden widths up to {MAX_WIDTH}, "
                            f"the config has {cfg.hidden_size}")
    if cfg.use_fused_layer_norm and (cfg.hidden_size % 8 or cfg.hidden_size > LAYER_NORM_MAX_WIDTH):
        problems.append(f"use_fused_layer_norm: the LayerNorm kernels take a hidden width that is a multiple of 8 "
                        f"up to {LAYER_NORM_MAX_WIDTH}, the config has {cfg.hidden_size}")
    if cfg.fast_dropout and cfg.dtype not in SITE_DTYPES:
        problems.append(f"fast_dropout: the dropout site kernels take bf16, fp16 or fp32 tensors on a "
                        f"{ALIGNMENT}-byte boundary, the config's dtype is {cfg.dtype}")
    if problems:
        raise ValueError("the config selects CUDA kernels outside their limits: " + "; ".join(problems))

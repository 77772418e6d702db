"""What the CUDA kernels take, checked where a model meets its device.

A config that selects a kernel (``use_flash_attention``, ``fused_mlm_xent``,
``use_fused_layer_norm``, ``fast_dropout``) with a dtype or width the kernel
cannot take would otherwise raise at the first step on the card. The JAX kernels take
any of them. :func:`check_kernel_limits` refuses such a config before the
first step, naming the limit and the flag:

* every attention form (``use_flash_attention``: the packed K1/K2 as
  shipped, the heads-major K11/K12 with ``packed_qkv`` false, the
  save-probs K13/K14 with ``flash_save_probs``): bf16, fp16 or fp32, head
  dim up to 128 (bf16 and fp16 on kernels built at head dims 16, 32, 64 and
  128, another head dim zero-padded to the next; fp32 on SIMT kernels at any
  head dim);
* the fused MLM cross-entropy (K4-K6): bf16, fp16 or fp32 at any hidden
  width (bf16 and fp16 on kernels built at 128, 256, 512, 768 and 1024 and
  on the wide form above 1024, another width zero-padded to the next of
  them or of 64; fp32 on its own tiled kernels);
* the residual LayerNorm (K7-K10): bf16, fp16 or fp32 at any hidden width
  up to 4096 (ALBERT-xxlarge's; a multiple of 8 up to 1024 on the vector
  kernels, other widths on the any-width forms);
* the dropout site (``fast_dropout``, K3's body): bf16, fp16 or fp32, any
  shape; its tensors must start on a 16-byte boundary, which every site's
  freshly allocated activation does, and the wrapper refuses one that does
  not when it is called.

On the CPU every flag runs its plain version, which takes any dtype and
width, so nothing is checked there. The sequence length is checked when a
kernel is called: the data, not the config, sets it (bf16 and fp16
attention at head dims above 64 runs on the kernels built at 128, where
K1's forward holds a head's keys in shared memory and takes T up to about
half of what 64 takes, while K2's streamed passes take any T; the forms at
16 and 32 take about four and two times 64's. A step runs a pair's forward
and backward, so each path takes T up to the least of its three kernels'
limits: at head dims up to 32 the backwards' (2880 / 1472 packed, 2880 /
1536 heads-major, 3072 / 1536 save-probs at 16 / 32), at 64 704, at 128
K1's 384 and K11/K12's 256; the wrapper names the limit).
"""

from __future__ import annotations

import torch

from visualbert_torch.ops.dropout import ALIGNMENT, SITE_DTYPES
from visualbert_torch.ops.flash_attention import MAX_HEAD_DIM, PACKED_DTYPES
from visualbert_torch.ops.mlm_xent import KERNEL_DTYPES

LAYER_NORM_MAX_WIDTH = 4096  # csrc/layer_norm.cu::MAX_WIDTH: 4 warps x 32 lanes x 8 elements x 4 chunks


def _attention_problems(cfg) -> list:
    if cfg.hidden_size % cfg.num_attention_heads:
        return [f"use_flash_attention: hidden_size {cfg.hidden_size} does not divide by "
                f"{cfg.num_attention_heads} heads"]
    if not cfg.packed_qkv:
        which = "heads-major attention kernels (K11/K12, packed_qkv false)"
    elif cfg.flash_save_probs:
        which = "save-probs attention kernels (K13/K14, flash_save_probs)"
    else:
        which = "packed attention kernels (K1/K2)"
    problems = []
    if cfg.dtype not in PACKED_DTYPES:
        problems.append(f"use_flash_attention: the {which} take bf16, fp16 or fp32, the config's dtype is "
                        f"{cfg.dtype}")
    if cfg.head_dim > MAX_HEAD_DIM:
        problems.append(f"use_flash_attention: the {which} take head dims up to {MAX_HEAD_DIM}, the config has "
                        f"hidden_size {cfg.hidden_size} over {cfg.num_attention_heads} heads")
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
    if cfg.fused_mlm_xent and cfg.dtype not in KERNEL_DTYPES:
        problems.append(f"fused_mlm_xent: the cross-entropy kernels take bf16, fp16 or fp32, the config's "
                        f"dtype is {cfg.dtype}")
    if cfg.use_fused_layer_norm and cfg.hidden_size > LAYER_NORM_MAX_WIDTH:
        problems.append(f"use_fused_layer_norm: the LayerNorm kernels take hidden widths up to "
                        f"{LAYER_NORM_MAX_WIDTH}, the config has {cfg.hidden_size}")
    if cfg.fast_dropout and cfg.dtype not in SITE_DTYPES:
        problems.append(f"fast_dropout: the dropout site kernels take bf16, fp16 or fp32 tensors on a "
                        f"{ALIGNMENT}-byte boundary, the config's dtype is {cfg.dtype}")
    if problems:
        raise ValueError("the config selects CUDA kernels outside their limits: " + "; ".join(problems))

"""Attention probing (ACL 2020 "What Does BERT with Vision Look At?";
counterpart of ``visualbert_tpu/tasks/probing.py``): the reference's
``output_attention_weights`` path (modeling.py:1316-1324, 1430-1444)
reduced to entity-to-region grounding hits, layer by layer.

:func:`entity_region_attention` gathers each entity row's attention over
the visual tokens from the ``[L, B, H, T, T]`` probabilities on their
device, so only ``[L, B, H, E, R]`` is copied to the host;
:func:`grounding_counts_from_era` (numpy, copied from the JAX module)
scores the argmax region of the mean over heads against the gold regions.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def entity_region_attention(attn_probs: torch.Tensor, flickr_position: torch.Tensor, text_len: int,
                            n_regions: int) -> torch.Tensor:
    """``attn_probs`` [L, B, H, T, T] and ``flickr_position`` [B, E] (-1 pad,
    gathered at 0) -> [L, B, H, E, n_regions]: each entity position's
    attention over the visual tokens ``text_len .. text_len + n_regions``."""
    L, B, H, _, T = attn_probs.shape
    E = flickr_position.shape[1]
    idx = flickr_position.clamp_min(0).long().to(attn_probs.device)
    rows = torch.gather(attn_probs, 3, idx[None, :, None, :, None].expand(L, B, H, E, T))  # [L, B, H, E, T]
    return rows[..., text_len: text_len + n_regions]


def grounding_counts_from_era(era: np.ndarray, flickr_position: np.ndarray, label: np.ndarray,
                              row_mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, int]:
    """Per-layer hits of the argmax region of the mean-over-heads attention
    ``era`` [L, B, H, E, R] against the regions with gold mass in ``label``
    [B, E, R], over the entities with ``flickr_position`` >= 0 of the rows
    ``row_mask`` [B] keeps (tail-pad duplicates dropped). Returns (hits [L],
    entities) so that batches sum exactly."""
    mean_heads = era.mean(axis=2)  # [L, B, E, R]
    valid = flickr_position >= 0
    if row_mask is not None:
        valid = valid & np.asarray(row_mask, bool)[:, None]
    hits = np.zeros(era.shape[0], np.int64)
    for layer in range(era.shape[0]):
        pred = mean_heads[layer].argmax(axis=-1)  # [B, E]
        hit = np.take_along_axis(label, pred[..., None], axis=2)[..., 0] > 0
        hits[layer] = int(hit[valid].sum())
    return hits, int(valid.sum())

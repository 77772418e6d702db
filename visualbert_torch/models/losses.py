"""Losses of the pretraining branch (counterpart of
``visualbert_tpu/models/losses.py``): fp32 logits in, fp32 scalars out."""

from __future__ import annotations

import torch


def cross_entropy_ignore_index(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss(ignore_index=-1)``: mean NLL over the
    positions whose label is not ``ignore_index`` (0 when there are none;
    reference modeling.py:1470-1485)."""
    logits = logits.reshape(-1, logits.shape[-1]).float()
    labels = labels.reshape(-1)
    valid = labels != ignore_index
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels.clamp_min(0)[:, None])[:, 0]
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum() / valid.sum().clamp_min(1)


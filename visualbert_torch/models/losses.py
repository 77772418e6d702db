"""Losses of the task heads and of the unsupervised stack (counterpart of
``visualbert_tpu/models/losses.py``): fp32 logits in, fp32 scalars out.

Every mean over the batch divides by :func:`denominator`. On several data
ranks (``Trainer`` runs the model inside :func:`global_denominators` of
its data group) that is the count summed over the group (detached), so
each rank's mean is its own numerator over the GLOBAL count, and the sum of
the ranks' values, which the Trainer takes for the gradients and the
metrics, is the mean over the global batch that the JAX package computes.
Averaging the ranks' own means would weight a rank with few labelled rows
as much as one with many. On one rank nothing changes.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_DATA_GROUP = None


@contextlib.contextmanager
def global_denominators(group):
    """Within the block, :func:`denominator` sums over ``group`` (None:
    this rank alone)."""
    global _DATA_GROUP
    previous, _DATA_GROUP = _DATA_GROUP, group
    try:
        yield
    finally:
        _DATA_GROUP = previous


def denominator(count: torch.Tensor) -> torch.Tensor:
    """The denominator of a batch mean: ``count`` (an element or label
    count, a weight sum) itself on one rank, its sum over the data group
    (fp32, no gradient) inside :func:`global_denominators`."""
    if _DATA_GROUP is None:
        return count
    total = count.detach().float().clone()
    dist.all_reduce(total, group=_DATA_GROUP)
    return total


def batch_mean(values: torch.Tensor) -> torch.Tensor:
    """``values.mean()`` over the global batch."""
    if _DATA_GROUP is None:
        return values.mean()
    return values.sum() / denominator(torch.tensor(values.numel(), device=values.device))


def masked_nll_mean(nll: torch.Tensor, labels: torch.Tensor, ignore_index: int = -1) -> torch.Tensor:
    """The mean of per-position NLLs over the labels that are not
    ``ignore_index``: ``CrossEntropyLoss(ignore_index=-1)``'s reduction of
    the NLLs the fused cross-entropy returns."""
    labels = labels.reshape(-1)
    valid = labels != ignore_index
    nll = torch.where(valid, nll.reshape(-1), torch.zeros((), device=nll.device))
    return nll.sum() / denominator(valid.sum()).clamp_min(1)


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
    return nll.sum() / denominator(valid.sum()).clamp_min(1)


def weighted_mean(values: torch.Tensor, weights=None) -> torch.Tensor:
    """Mean of per-example ``values`` under optional per-example ``weights``
    (1.0 real / 0.0 tail-pad duplicate, ``Batcher(pad_final=True)``)."""
    values = values.float()
    if weights is None:
        return batch_mean(values)
    w = weights.float()
    return (values * w).sum() / denominator(w.sum()).clamp_min(1e-12)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, weights=None) -> torch.Tensor:
    """``torch.nn.CrossEntropyLoss()``: the mean NLL over the batch, weighted
    when the batch carries ``example_weight``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return weighted_mean(-logp.gather(-1, labels[..., None].long())[..., 0], weights)


def kl_div_batchmean(log_probs: torch.Tensor, target: torch.Tensor, weights=None) -> torch.Tensor:
    """``torch.nn.KLDivLoss(reduction='batchmean')`` with the 0 * log(0) = 0
    convention (reference modeling.py:1517-1521); ``weights`` turn the / B
    into a weighted per-example mean."""
    log_probs, target = log_probs.float(), target.float()
    zero = torch.zeros((), device=target.device)
    safe_log_t = torch.where(target > 0, torch.log(target.clamp_min(1e-30)), zero)
    elt = torch.where(target > 0, target * (safe_log_t - log_probs), zero)
    return weighted_mean(elt.reshape(elt.shape[0], -1).sum(dim=-1), weights)


def binary_cross_entropy_with_logits(logits: torch.Tensor, target: torch.Tensor, weights=None) -> torch.Tensor:
    """``torch.nn.BCEWithLogitsLoss()``, the mean over every element (the
    unsupervised stack's VQA loss, reference tasks/vqa.py:106), in the
    stable form ``max(x, 0) - x t + log(1 + exp(-|x|))``; ``weights`` make
    the mean over rows a weighted one."""
    logits, target = logits.float(), target.float()
    loss = logits.clamp_min(0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    return weighted_mean(loss.reshape(loss.shape[0], -1).mean(dim=-1), weights)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise ``torch.nn.SmoothL1Loss(reduction='none')``, beta 1."""
    diff = (pred.float() - target.float()).abs()
    return torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)


def vqa_accuracy_scores(logits: torch.Tensor, soft_labels: torch.Tensor) -> torch.Tensor:
    """Reference ``compute_score_with_logits`` (modeling.py:1697-1703):
    softmax, class 0 (<unk>) zeroed, renormalised, argmax, and the soft label
    mass at the argmax; per-example scores."""
    probs = torch.softmax(logits.float(), dim=-1)
    probs = torch.cat([torch.zeros_like(probs[:, :1]), probs[:, 1:]], dim=1)
    probs = probs / probs.sum(dim=1, keepdim=True).clamp_min(1e-12)
    pred = probs.argmax(dim=-1)
    return soft_labels.float().gather(1, pred[:, None])[:, 0]

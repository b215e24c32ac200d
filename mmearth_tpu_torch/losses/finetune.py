"""Finetuning criteria (port of ``mmearth_tpu/losses/finetune.py``; reference
main_finetune.py:40-57, custom_loss.py:33-63).

  m-eurosat / m-so2sat / m-brick-kiln: label-smoothing cross-entropy (timm's
    LabelSmoothingCrossEntropy: (1-s)*nll + s*mean(-logp)).
  m-bigearthnet: label-smoothing binary cross-entropy (custom_loss.py:33-51).
  m-cashew-plant / m-SA-crop-type: plain CE over pixels, logits reshaped
    NHWC -> (N*H*W, C) (engine_finetune.py:104-119).

Every loss is computed in f32 whatever the logits' dtype.  ``dice_loss`` is
upstream's ``DiceLoss`` (custom_loss.py:54-63), which no main uses.

Across ranks: each criterion is a mean over the batch (over its N*H*W
pixels for segmentation) and every rank's training batch has the same
size, so the mean of the ranks' losses is the global batch's, and the
optimizer's average of their gradients is its gradient; the driver
averages the losses it reports.  The Dice score is not a mean: its TP, FP
and FN sums are summed over the ``process_group`` before the score.
"""
from __future__ import annotations

import torch

from ..parallel.mesh import sum_


def smoothed_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           smoothing: float = 0.0) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    # a label outside [0, C) selects no class and adds nothing to the nll, as JAX's one-hot
    onehot = labels.long()[..., None] == torch.arange(logits.shape[-1], device=logits.device)
    nll = -torch.where(onehot, logp, torch.zeros_like(logp)).sum(-1)
    smooth = -logp.mean(-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def smoothed_binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                  smoothing: float = 0.0) -> torch.Tensor:
    t = targets.float()
    if smoothing > 0:
        t = t * (1.0 - smoothing) + (1.0 - t) * smoothing
    x = logits.float()
    # numerically stable BCE with logits
    return (x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def segmentation_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits: (N, H, W, C); labels: (N, H, W) or (N, 1, H, W) int."""
    labels = labels.reshape(logits.shape[:3])
    return smoothed_cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1), 0.0)


def dice_loss(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
              process_group=None) -> torch.Tensor:
    """1 - macro Dice over hard (argmax) predictions, upstream's ``DiceLoss``
    (custom_loss.py:54-63: softmax -> argmax -> torchmetrics ``Dice(average=
    "macro")``); no main uses it.  The argmax makes it an eval-style
    criterion with no gradient.  Per class c: 2 TP / (2 TP + FP + FN),
    averaged over the classes with a nonzero denominator; the counts are
    the global batch's under a ``process_group``."""
    pred = logits.float().argmax(-1).reshape(-1)
    t = target.reshape(-1).long()
    classes = torch.arange(num_classes, device=logits.device)
    p1 = pred[:, None] == classes
    t1 = t[:, None] == classes
    tp = (p1 & t1).sum(0).float()
    fp = (p1 & ~t1).sum(0).float()
    fn = (~p1 & t1).sum(0).float()
    tp, fp, fn = sum_(torch.stack([tp, fp, fn]), process_group).unbind()
    denom = 2.0 * tp + fp + fn
    support = denom > 0
    score = torch.where(support, 2.0 * tp / torch.where(support, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom))
    return 1.0 - score.sum() / support.sum().float().clamp(min=1.0)


def criterion_fn(dataset: str, smoothing: float):
    """Per-dataset criterion (main_finetune.py:40-57)."""
    if dataset == "m-bigearthnet":
        return lambda logits, target: smoothed_binary_cross_entropy(logits, target, smoothing)
    if dataset in ("m-cashew-plant", "m-SA-crop-type"):
        return segmentation_cross_entropy
    return lambda logits, target: smoothed_cross_entropy(logits, target, smoothing)

"""Multi-pretext losses for MP-MAE (port of ``mmearth_tpu/losses/multipretext.py``).

The four loss families of the reference (fcmae.py:267-412) and its
uncertainty aggregation (custom_loss.py:10-30), with masked reductions in
place of boolean indexing:

  * image-level categorical (biome, eco_region): cross-entropy against the
    argmax of the one-hot target;
  * image-level continuous (lat, lon, month, era5): MSE over non-NaN elements;
  * pixel categorical (dynamic_world, esa_worldcover): cross-entropy over the
    masked patches, ignoring -1 labels;
  * pixel continuous (sentinel2, sentinel1, aster, canopy_height_eth):
    per-patch NaN-aware MSE over masked patches; patches whose every element
    is NaN count as NaN and drop out, and the denominator counts the patches
    with a nonzero masked loss, exactly as ``count_nonzero(loss * mask)``.

An empty valid set gives 0 instead of NaN.

Each loss is a numerator over a denominator (a count, or the batch size).
Under a process group, :func:`multipretext_loss` sums both over the ranks,
every modality's in one all-reduce, before it divides: each rank's loss is
then the global batch's loss that JAX's sharded step computes.  The
numerators are summed with ``parallel/mesh.py::all_reduce_sum``, whose
backward sums the gradient over the ranks too, so each rank's gradient is
the global loss's times the rank count and the optimizer averages the
gradients over the ranks.  (Averaging per-rank losses, as upstream's DDP
does, is not the global loss once the ranks' valid counts differ.)
"""
from __future__ import annotations

from typing import Mapping

import torch

from ..configs import modalities as M
from ..parallel.mesh import all_reduce_sum


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, L, p*p*C): per patch, pixels row-major then channels."""
    n, h, w, c = imgs.shape
    p = patch_size
    x = imgs.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, patch_size: int, img_size: int, channels: int) -> torch.Tensor:
    """(N, L, p*p*C) -> (N, H, W, C), the inverse of :func:`patchify`."""
    n, p = x.shape[0], patch_size
    g = img_size // p
    x = x.reshape(n, g, g, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, img_size, img_size, channels)


def _ratio(num, den):
    """num / den, 0 where den is 0."""
    return torch.where(den > 0, num / den.clamp(min=1.0), torch.zeros_like(num))


def _masked_sum(values, valid):
    """(sum of the valid values, their count)."""
    return torch.where(valid, values, torch.zeros_like(values)).sum(), valid.float().sum()


def _safe_mean(values, valid):
    return _ratio(*_masked_sum(values, valid))


def cross_entropy(logits, labels):
    """Per-example softmax CE with integer labels (labels clipped into range)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    return lse - torch.gather(logits, -1, safe[..., None])[..., 0]


def _image_categorical_parts(pred, target_onehot):
    total = cross_entropy(pred, target_onehot.argmax(-1)).sum()
    return total, torch.full_like(total, pred.shape[0])


def image_categorical_loss(pred, target_onehot):
    return _ratio(*_image_categorical_parts(pred, target_onehot))


def _image_continuous_parts(pred, target):
    target = target.float()
    valid = ~torch.isnan(target)
    sq = (pred.float() - torch.where(valid, target, torch.zeros_like(target))).square()
    return _masked_sum(sq, valid)


def image_continuous_loss(pred, target):
    return _ratio(*_image_continuous_parts(pred, target))


def _pixel_categorical_parts(pred, target, mask, patch_size: int, num_classes: int):
    n, l, _ = pred.shape
    pp = patch_size * patch_size
    logits = pred.reshape(n, l, pp, num_classes)
    labels = patchify(target.long(), patch_size).reshape(n, l, pp)
    ce = cross_entropy(logits, labels)
    valid = (mask[:, :, None] == 1) & (labels != -1)
    return _masked_sum(ce, valid)


def pixel_categorical_loss(pred, target, mask, patch_size: int, num_classes: int):
    """pred (N, L, p*p*classes); target (N, H, W, 1) int labels, -1 = no data;
    mask (N, L), 1 = removed."""
    return _ratio(*_pixel_categorical_parts(pred, target, mask, patch_size, num_classes))


def _pixel_continuous_parts(pred, target, mask, patch_size: int, norm_pix: bool = False):
    tgt = patchify(target.float(), patch_size)
    if norm_pix:
        mean = tgt.mean(-1, keepdim=True)
        var = tgt.var(-1, unbiased=False, keepdim=True)
        tgt = (tgt - mean) / torch.sqrt(var + 1e-6)
    sq = (pred.float() - tgt).square()
    valid = ~torch.isnan(sq)
    count = valid.sum(-1)
    per_patch = torch.where(valid, sq, torch.zeros_like(sq)).sum(-1) / count.clamp(min=1)
    per_patch = torch.where(count > 0, per_patch, torch.full_like(per_patch, float("nan")))
    tmp = per_patch * mask
    tmp = torch.where(torch.isnan(tmp), torch.zeros_like(tmp), tmp)
    return tmp.sum(), (tmp != 0.0).float().sum()


def pixel_continuous_loss(pred, target, mask, patch_size: int, norm_pix: bool = False):
    """pred (N, L, p*p*C); target (N, H, W, C) float; mask (N, L)."""
    return _ratio(*_pixel_continuous_parts(pred, target, mask, patch_size, norm_pix))


def multipretext_loss(preds: Mapping[str, torch.Tensor], targets: Mapping[str, torch.Tensor],
                      mask: torch.Tensor, *, patch_size: int, out_chans: Mapping[str, int],
                      norm_pix_loss: bool = False, loss_full: bool = False,
                      process_group=None) -> dict:
    """Per-modality losses, keyed (and ordered) like ``preds``; with a
    ``process_group``, the global batch's (numerators and denominators
    summed over its ranks in one all-reduce)."""
    if loss_full:
        mask = torch.ones_like(mask)
    parts = []
    for name, pred in preds.items():
        if name in ("biome", "eco_region"):
            parts.append(_image_categorical_parts(pred, targets[name]))
        elif name in M.IMAGE_LEVEL_MODALITIES:
            parts.append(_image_continuous_parts(pred, targets[name]))
        elif name in M.CATEGORICAL_PIXEL_MODALITIES:
            parts.append(_pixel_categorical_parts(pred, targets[name], mask, patch_size,
                                                  out_chans[name]))
        else:
            parts.append(_pixel_continuous_parts(
                pred, targets[name], mask, patch_size,
                norm_pix=(norm_pix_loss and name == "sentinel2")))
    sums = all_reduce_sum(torch.stack([x for part in parts for x in part]), process_group)
    losses = _ratio(sums[0::2], sums[1::2])
    return dict(zip(preds, losses.unbind()))


def uncertainty_weighted(loss_dict: Mapping[str, torch.Tensor], log_vars: torch.Tensor):
    """sum_t exp(-s_t) * L_t + s_t, with a task whose raw loss is 0 (dropped)
    contributing 0."""
    losses = torch.stack(list(loss_dict.values()))
    weighted = torch.exp(-log_vars) * losses + log_vars
    weighted = weighted * (losses != 0.0)
    return weighted.sum(), weighted


def unweighted(loss_dict: Mapping[str, torch.Tensor]):
    losses = torch.stack(list(loss_dict.values()))
    return losses.sum(), losses

"""The pretraining step (port of ``mmearth_tpu/train/step.py::make_pretrain_step``):
aligned random crop, NaN zeroing, masked forward, multi-pretext loss,
backward and the optimizer update, with no host synchronisation."""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..models import fcmae as fcmae_lib
from .optim import AdamW, global_norm


def to_device(batch: Mapping, device) -> dict[str, torch.Tensor]:
    """numpy (or tensor) batch -> tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
        if t.device.type == "cpu" and torch.device(device).type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def fold_in(gen: torch.Generator, step: int) -> torch.Generator:
    """A generator for one step, a function of ``gen``'s seed and ``step``
    only (``jax.random.fold_in`` of the JAX step), so a resumed run draws the
    same crops and masks."""
    return torch.Generator(device=gen.device).manual_seed(
        (gen.initial_seed() * 1_000_003 + step) % (2 ** 63))


def pretrain_step(model: fcmae_lib.FCMAE, opt: AdamW, batch: Mapping[str, torch.Tensor],
                  step: int, gen: torch.Generator, random_crop: bool = True,
                  mask: Optional[torch.Tensor] = None,
                  loss_sum: Optional[torch.Tensor] = None) -> dict[str, torch.Tensor]:
    """One training step on ``batch`` (NHWC modality tensors on the model's
    device, at tile resolution).  ``fold_in(gen, step)`` (``gen`` on that
    device) draws the crop offsets and the mask; ``mask`` overrides the drawn
    mask.  Adds the loss
    to ``loss_sum`` in place when given.  Returns detached on-device metrics:
    ``loss``, ``grad_norm``, ``loss_<modality>``, and with uncertainty
    weighting ``log_vars`` and ``normalized_loss``."""
    gen = fold_in(gen, step)
    if random_crop and batch["sentinel2"].shape[1] > model.img_size:
        batch = fcmae_lib.aligned_random_crop(batch, model.img_size, gen)
    batch = fcmae_lib.zero_nan_inputs(batch)
    opt.zero_grad()
    loss, _, _, loss_dict, log_vars, weighted = model(batch, mask=mask, generator=gen)
    loss.backward()
    grads = [p.grad for p in opt.params if p.grad is not None]
    metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads).detach()}
    opt.step()
    if loss_sum is not None:
        loss_sum.add_(metrics["loss"].float())
    metrics.update({f"loss_{k}": v.detach() for k, v in loss_dict.items()})
    if log_vars is not None:
        metrics["log_vars"] = log_vars.detach().clone()
        metrics["normalized_loss"] = weighted.detach().sum()
    return metrics

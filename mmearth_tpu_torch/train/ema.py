"""Model EMA (port of ``mmearth_tpu/train/ema.py``; the reference's
--model_ema machinery, main_finetune.py:96-101, never enabled in the
published recipes): an f32 copy of every param, keyed by name."""
from __future__ import annotations

import torch
from torch import nn


def init_ema(model: nn.Module) -> dict[str, torch.Tensor]:
    return {name: p.detach().float().clone() for name, p in model.named_parameters()}


@torch.no_grad()
def update_ema(ema: dict[str, torch.Tensor], model: nn.Module, decay: float = 0.9999) -> None:
    """ema = ema * decay + param * (1 - decay), in place; decay 1.0 leaves
    it as it is (the accumulation-only steps, JAX train/finetune.py:106-116)."""
    for name, p in model.named_parameters():
        ema[name].mul_(decay).add_(p.float(), alpha=1.0 - decay)

"""Typed pretraining configuration (the port's copy of the pretrain side of
``mmearth_tpu/configs/config.py``).

The CLI façade ``mmearth_tpu_torch/main_pretrain.py`` keeps the reference flag
names and fills these dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from . import modalities as M

# Model size table (reference models/fcmae.py:459-496, convnextv2.py:210-247).
MODEL_SIZES: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {
    "atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "femto": ((2, 2, 6, 2), (48, 96, 192, 384)),
    "pico": ((2, 2, 6, 2), (64, 128, 256, 512)),
    "nano": ((2, 2, 8, 2), (80, 160, 320, 640)),
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "huge": ((3, 3, 27, 3), (352, 704, 1408, 2816)),
}


def model_size(name: str) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(depths, dims) from a reference model name, e.g. ``convnextv2_atto``."""
    key = name.split("_")[-1]
    if key not in MODEL_SIZES:
        raise ValueError(f"unknown model size in {name!r}; options: {sorted(MODEL_SIZES)}")
    return MODEL_SIZES[key]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """FCMAE / ConvNeXtV2 architecture config."""

    model: str = "convnextv2_pico"
    img_size: int = 112
    patch_size: int = 16
    mask_ratio: float = 0.6
    decoder_depth: int = 1
    decoder_embed_dim: int = 512
    norm_pix_loss: bool = False
    # MaskedGRN statistic scope: "per_device" = the local batch (the
    # reference's per-GPU DDP semantics), "global" = the whole batch.  Identical
    # on one device.
    grn_scope: str = "per_device"
    # masked-block implementation; this port runs the gathered encoder with the
    # dwconv7_gathered kernel for every accepted value (models/convnextv2.py)
    block_impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    blr: float = 1.5e-4
    lr: float | None = None  # absolute lr; derived from blr if None
    min_lr: float = 0.0
    weight_decay: float = 0.05
    warmup_epochs: int = 40
    betas: tuple[float, float] = (0.9, 0.95)
    update_freq: int = 1  # gradient accumulation steps
    clip_grad: float | None = None

    def absolute_lr(self, eff_batch_size: int) -> float:
        # reference main_pretrain.py:297-298
        return self.lr if self.lr is not None else self.blr * eff_batch_size / 256


@dataclasses.dataclass(frozen=True)
class DataConfig:
    data_dir: str = ""
    processed_dir: str | None = None
    batch_size: int = 64
    random_crop: bool = True
    inp_modalities: Mapping[str, Any] = dataclasses.field(default_factory=lambda: dict(M.INP_MODALITIES))
    out_modalities: Mapping[str, Any] = dataclasses.field(default_factory=lambda: dict(M.OUT_MODALITIES))
    debug: bool = False  # 10-sample subset, mirrors reference --debug
    # train-split sampling order: random | quasi_random | sequential
    order: str | None = None


@dataclasses.dataclass(frozen=True)
class RunConfig:
    epochs: int = 800
    start_epoch: int = 0
    seed: int = 0
    output_dir: str = ""
    resume: str = ""
    loss_aggr: str = "uncertainty"  # or "unweighted"
    loss_full: bool = False  # recon loss on all patches, not just masked
    use_bf16: bool = True  # bf16 compute over f32 params


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)

"""Typed pretraining and finetuning configuration (the port's copy of
``mmearth_tpu/configs/config.py``).

The CLI façades ``mmearth_tpu_torch/main_pretrain.py`` and
``mmearth_tpu_torch/main_finetune.py`` keep the reference flag names and fill
these dataclasses.
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
    # masked-block implementation of the block tail (models/convnextv2.py):
    # "spillg"/"wholeblock" take the spill-g kernels on the gathered path,
    # "fused" the masked-dense kernels on the masked-dense path, "folded"
    # folds the norms into the products on the gathered path, "remat"
    # composes the tail under torch.utils.checkpoint; every other value, and
    # every value on another path, composes the tail
    block_impl: str = "auto"
    # sparse-encoder strategy: "gathered" computes every site-local op on the
    # visible patches only; "masked_dense" runs the full grid with re-masking.
    # Both compute the same function.
    sparse_impl: str = "gathered"
    use_orig_stem: bool = False
    # sparse=True reproduces the MinkowskiEngine semantics; sparse=False the
    # reference's "leaky" dense path (mask applied to the input only)
    sparse: bool = True
    # tanh-approximate GELU everywhere (opt-in; the reference's is the exact
    # erf GELU, which the kernel tails compute, so this composes the tails)
    gelu_approx: bool = False
    # the classifier's padding: "same" everywhere, or "reference" (upstream's
    # dense model: VALID initial conv, stride//2-padded stem; dense only)
    padding_mode: str = "same"


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    blr: float = 1.5e-4
    lr: float | None = None  # absolute lr; derived from blr if None
    min_lr: float = 0.0
    weight_decay: float = 0.05
    warmup_epochs: int = 40
    betas: tuple[float, float] = (0.9, 0.95)
    update_freq: int = 1  # gradient accumulation steps
    layer_decay: float = 1.0
    layer_decay_type: str = "single"  # or "group"
    clip_grad: float | None = None
    # reference --opt family (optim_factory.py:149-252; train/optim.py::
    # FAMILIES); finetune only
    opt: str = "adamw"
    opt_eps: float = 1e-8
    momentum: float = 0.9

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
    # the most threads of the native row gather (data/native::threads_for)
    num_workers: int = 10
    # mmpack (packed, memory-mapped), grain (ArrayRecord shards) or hdf5
    # (streamed from the MMEarth HDF5); a missing split is packed from
    # data_dir first (mmpack, grain)
    loader: str = "mmpack"
    # train-split sampling order for mmpack: random | quasi_random | sequential
    order: str | None = None

    @property
    def modalities(self) -> dict[str, Any]:
        """Union of input and output modalities, input first (reference
        main_pretrain.py:175-181)."""
        return {**self.inp_modalities, **self.out_modalities}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    epochs: int = 800
    start_epoch: int = 0
    seed: int = 0
    output_dir: str = ""
    log_dir: str | None = None  # TensorBoard event files (needs tensorboardX)
    resume: str = ""
    # with an output_dir: resume from its newest checkpoint-<epoch>.pth, and
    # save one every save_ckpt_freq epochs (and the last), keeping the newest
    # save_ckpt_num
    auto_resume: bool = True
    save_ckpt: bool = True
    save_ckpt_freq: int = 1
    save_ckpt_num: int = 3
    loss_aggr: str = "uncertainty"  # or "unweighted"
    loss_full: bool = False  # recon loss on all patches, not just masked
    use_bf16: bool = True  # bf16 compute over f32 params
    # pretraining steps a dispatch: k > 1 runs groups of k batches as one
    # replay of a captured CUDA graph (train/step.py::ChainedStep)
    steps_per_dispatch: int = 1
    # Weights & Biases logging (utils/logging.py::maybe_wandb); training goes
    # on without it where the package is missing
    wandb: bool = False
    wandb_project: str = "global-lr"
    wandb_run_name: str | None = None


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """GEO-Bench finetuning / linear probe (the recipe of TRAINING.md)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(
        default_factory=lambda: OptimConfig(blr=2e-4, weight_decay=0.3, warmup_epochs=0,
                                            betas=(0.9, 0.999), layer_decay=0.9))
    run: RunConfig = dataclasses.field(
        default_factory=lambda: RunConfig(epochs=100, loss_aggr="unweighted"))
    data_set: str = "m-eurosat"
    partition: str = "default"
    geobench_bands_type: str = "full"
    processed_dir: str | None = None
    nb_classes: int = 10
    in_channels: int = 12
    finetune: str = ""  # path to the pretrain checkpoint
    # imnet-pretrained baseline weights: swap bgr geobench bands to rgb in the
    # step (reference --use_imnet_weights + engine_finetune.py:92-95)
    use_imnet_weights: bool = False
    linear_probe: bool = False
    smoothing: float = 0.2
    drop_path: float = 0.1
    head_init_scale: float = 0.001
    batch_size: int = 32
    num_workers: int = 10
    # segmentation's staged unfreeze (reference main_finetune.py:598-619): the
    # U-Net probe trains its whole model from this epoch on (no CLI flag, as
    # in the JAX package)
    unfreeze_epoch: int = 50
    # model EMA (reference --model_ema / --model_ema_decay / --model_ema_eval,
    # main_finetune.py:96-101; defined but unused by the published recipes)
    model_ema: bool = False
    model_ema_decay: float = 0.9999
    model_ema_eval: bool = False

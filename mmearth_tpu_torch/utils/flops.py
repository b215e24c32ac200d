"""Dot and convolution FLOP count of a training step (port of
``mmearth_tpu/utils/flops.py``), for the bench's MFU.

``step_flops(fn, *args)`` runs ``fn`` once under
``torch.utils.flop_counter.FlopCounterMode`` and returns the FLOPs of the
matrix products and convolutions it dispatched (2 * M * N * K a product,
2 * outputs * taps * input channels a group for a convolution; the
backward's included when ``fn`` runs one), the convention of the JAX
package's jaxpr walk and of published MFU figures.  Elementwise work is
excluded.

The count must be taken on CPU tensors: there every kernel wrapper runs its
plain PyTorch version, whose products the counter sees, while on the card
the hand-written kernels are ctypes launches the counter cannot see.
:func:`pretrain_step_flops` and :func:`finetune_step_flops` build the
bench's configurations on the CPU at a small batch and count one step; the
count is linear in the batch, so the bench scales it by its own.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, as PERF.md's bounds use


def step_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn`` (typically a train step incl. fwd+bwd)."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def pretrain_step_flops(model_name: str, img: int, patch: int, batch: int) -> float:
    """The model FLOPs of one pretraining step (forward, backward, AdamW) of
    the bench's FCMAE configuration at ``batch``, on the CPU, on the bench's
    synthetic batch (tiles of ``img + 8`` px, cropped to ``img``).  The
    gathered encoder with the composed block tail (``block_impl="auto"``):
    the spill-g kernels compute the same function but recompute two
    products a block in the backward (``v`` in D, ``dh`` in both C and D),
    which the count of their plain phases would add (2.842 against 2.468
    GFLOP/sample at atto56); the MFU of every block tail counts the model's."""
    from ..configs.config import DataConfig, ModelConfig, PretrainConfig, RunConfig
    from ..data.synthetic import bench_batch
    from ..train.optim import AdamW
    from ..train.pretrain import build_model
    from ..train.schedule import warmup_cosine
    from ..train.step import pretrain_step, to_device

    cfg = PretrainConfig(
        model=ModelConfig(model=model_name, img_size=img, patch_size=patch, block_impl="auto"),
        data=DataConfig(batch_size=batch), run=RunConfig(seed=0))
    model = build_model(cfg, "cpu")
    opt = AdamW(model.named_parameters(), warmup_cosine(1.5e-4, 0.0, 200, 40, 1000),
                cfg.optim.weight_decay, cfg.optim.betas)
    data = to_device(bench_batch(batch, img + 8), "cpu")
    gen = torch.Generator().manual_seed(0)
    return step_flops(pretrain_step, model, opt, data, 0, gen)


def finetune_step_flops(model_name: str, img: int, patch: int, bands: int, classes: int,
                        batch: int, data_set: str = "m-eurosat", smoothing: float = 0.2) -> float:
    """FLOPs of one finetune step (every param training, drop path 0.1) of
    the classifier or the U-Net at ``batch``, on the CPU."""
    import numpy as np

    from ..configs.config import FinetuneConfig, ModelConfig, RunConfig
    from ..losses.finetune import criterion_fn
    from ..train.finetune import (build_finetune_model, finetune_step, full_trainable,
                                  make_optimizer)
    from ..train.step import fold_in, to_device

    cfg = FinetuneConfig(model=ModelConfig(model=model_name, img_size=img, patch_size=patch),
                         run=RunConfig(epochs=100, seed=0, loss_aggr="unweighted"),
                         data_set=data_set, drop_path=0.1, smoothing=smoothing,
                         batch_size=batch)
    model = build_finetune_model(cfg, bands, classes)
    opt = make_optimizer(cfg, model, full_trainable(model), 100 * batch)
    rng = np.random.default_rng(0)
    seg = "unet" in model_name
    data = to_device({
        "input": rng.normal(size=(batch, img, img, bands)).astype(np.float32),
        "label": rng.integers(0, classes, size=(batch, img, img) if seg else (batch,))
        .astype(np.int32)}, "cpu")
    gen = torch.Generator().manual_seed(0)
    return step_flops(finetune_step, model, opt, data, criterion_fn(data_set, smoothing),
                      fold_in(gen, 0))


def mfu(flops_per_step: float, ms_per_step: float, peak: float = PEAK_BF16_FLOPS) -> float:
    """Model FLOPs utilisation: the step's FLOPs over its time at ``peak``."""
    return flops_per_step / (ms_per_step / 1e3) / peak

"""Pretraining loop (port of ``mmearth_tpu/train/pretrain.py``; reference
main_pretrain.py:165-391 + engine_pretrain.py:21-122) on one device.

The loader feeds mmpack batches; every step adds its loss to an on-device
``loss_sum`` and keeps its loss tensor, and both are read once at the end of
the epoch: the epoch loss is the exact mean over all steps, with no per-step
host synchronisation.  A non-finite loss stops the run (engine_pretrain.py:83-85).
With an output directory the run saves ``checkpoint-<epoch>.pth`` files and
resumes from the newest (``checkpoints/pth_io.py``; JAX
train/pretrain.py:177-215,304-306).
"""
from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import torch

from ..checkpoints import pth_io
from ..configs.config import PretrainConfig, RunConfig, model_size
from ..data.loader import PackedDataset, PackedLoader
from ..models.fcmae import FCMAE
from .optim import AdamW
from .schedule import warmup_cosine
from .step import pretrain_step, to_device

PRINT_FREQ = 20


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; asking for CUDA without a usable card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return dev


def build_model(cfg: PretrainConfig, device="cuda") -> FCMAE:
    """FCMAE for ``cfg``, initialised from ``cfg.run.seed`` (on the CPU, so
    the weights do not depend on the device), then moved to ``device``."""
    dev = resolve_device(device)
    depths, dims = model_size(cfg.model.model)
    model = FCMAE(
        img_size=cfg.model.img_size, patch_size=cfg.model.patch_size, depths=depths, dims=dims,
        decoder_depth=cfg.model.decoder_depth, decoder_embed_dim=cfg.model.decoder_embed_dim,
        mask_ratio=cfg.model.mask_ratio, norm_pix_loss=cfg.model.norm_pix_loss,
        grn_group=cfg.data.batch_size if cfg.model.grn_scope == "per_device" else 0,
        block_impl=cfg.model.block_impl, sparse_impl=cfg.model.sparse_impl,
        loss_aggr=cfg.run.loss_aggr,
        loss_full=cfg.run.loss_full, inp_modalities=cfg.data.inp_modalities,
        out_modalities=cfg.data.out_modalities,
        dtype=torch.bfloat16 if cfg.run.use_bf16 else torch.float32,
    )
    model.init_weights(torch.Generator().manual_seed(cfg.run.seed))
    return model.to(dev)


def get_dataloader(cfg: PretrainConfig, split: str = "train"):
    """mmpack split ``<processed_dir or data_dir>/<split>``."""
    path = Path(cfg.data.processed_dir or cfg.data.data_dir) / split
    if not (path / "meta.json").exists():
        raise FileNotFoundError(
            f"no mmpack split at {path}: this port reads packed data only (write synthetic "
            "data with `python -m mmearth_tpu_torch.data.synthetic`, or pack the HDF5 with "
            "`python -m mmearth_tpu.data.pack`); packing HDF5 in the port is not ported yet")
    ds = PackedDataset(path)
    is_train = split == "train"
    loader = PackedLoader(
        ds, batch_size=cfg.data.batch_size, shuffle=is_train, drop_last=is_train,
        seed=cfg.run.seed, indices=list(range(min(10, len(ds)))) if cfg.data.debug else None,
        order=cfg.data.order if is_train else "sequential")
    return ds, loader


def run_pretrain(cfg: PretrainConfig, device="cuda", args: dict | None = None):
    """Train; returns (model, history, optimizer), one history entry per epoch
    run with the exact mean ``loss``, ``steps``, wall ``seconds`` and
    ``step_losses``.  ``args`` (the CLI's flags) is stored in every
    checkpoint."""
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    ds, loader = get_dataloader(cfg)
    n_samples = len(loader.base_indices)
    eff_batch = cfg.data.batch_size * cfg.optim.update_freq
    updates_per_epoch = max(n_samples // eff_batch, 1)
    lr = cfg.optim.absolute_lr(eff_batch)
    schedule = warmup_cosine(lr, cfg.optim.min_lr, cfg.run.epochs, cfg.optim.warmup_epochs,
                             updates_per_epoch)
    opt = AdamW(model.named_parameters(), schedule, cfg.optim.weight_decay, cfg.optim.betas,
                update_freq=cfg.optim.update_freq, clip_grad=cfg.optim.clip_grad)
    n_params = sum(p.numel() for p in model.parameters())
    n_enc = sum(p.numel() for p in model.encoder.parameters())
    print(f"device {dev}  effective batch size: {eff_batch}  actual lr: {lr:.2e}  "
          f"updates/epoch: {updates_per_epoch}  params: {n_params} (encoder: {n_enc})")

    ckpt_dir = cfg.run.output_dir if (cfg.run.output_dir and cfg.run.save_ckpt) else None
    start_epoch = resume(cfg.run, model, opt, ckpt_dir)
    ckpt_args = dict(args or {})
    gen = torch.Generator(device=dev).manual_seed(cfg.run.seed)
    history = []
    step = start_epoch * len(loader)  # fold_in(gen, step) continues the run's draws
    for epoch in range(start_epoch, cfg.run.epochs):
        t0 = time.time()
        loader.set_epoch(epoch)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        step_losses = []
        for i, host_batch in enumerate(loader):
            batch = to_device(host_batch, dev)
            metrics = pretrain_step(model, opt, batch, step, gen,
                                    random_crop=cfg.data.random_crop, loss_sum=loss_sum)
            step_losses.append(metrics["loss"])
            step += 1
            if i % PRINT_FREQ == 0:
                _check_finite(float(metrics["loss"]))
                print(f"Epoch: [{epoch}] [{i}/{len(loader)}] loss {float(metrics['loss']):.4f} "
                      f"lr {schedule(opt.count):.3e}")
        losses = torch.stack(step_losses).float().tolist() if step_losses else []
        for v in losses:
            _check_finite(v)
        mean = float(loss_sum) / max(len(losses), 1)
        seconds = time.time() - t0
        history.append({"epoch": epoch, "loss": mean, "steps": len(losses),
                        "seconds": seconds, "step_losses": losses})
        print(f"epoch {epoch} done  avg loss {mean:.4f}  "
              f"~{len(losses) * cfg.data.batch_size / max(seconds, 1e-9):.0f} samples/s")
        if ckpt_dir and ((epoch + 1) % cfg.run.save_ckpt_freq == 0 or epoch + 1 == cfg.run.epochs):
            pth_io.save_checkpoint(ckpt_dir, epoch, model, opt, ckpt_args,
                                   keep=cfg.run.save_ckpt_num)
    return model, history, opt


def resume(run: RunConfig, model, opt, ckpt_dir, ema=None) -> int:
    """Restore ``--resume`` (a ``.pth`` or an output directory), else with
    ``--auto_resume`` the newest checkpoint in ``ckpt_dir``; returns the
    epoch to start from: the checkpoint's epoch + 1, or ``--start_epoch``
    (nothing to resume, or a file that holds the model alone)."""
    path = (pth_io.resolve(run.resume) if run.resume
            else pth_io.latest_checkpoint(ckpt_dir) if (ckpt_dir and run.auto_resume)
            else None)
    if path is None:
        return run.start_epoch
    epoch = pth_io.restore(path, model, opt, ema)
    if epoch is None:
        print(f"resumed the params from {path}; epoch {run.start_epoch} from --start_epoch")
        return run.start_epoch
    print(f"resumed from {path} (epoch {epoch})")
    return epoch + 1


def _check_finite(loss: float) -> None:
    if not math.isfinite(loss):
        print(f"Loss is {loss}, stopping training")  # engine_pretrain.py:83-85
        sys.exit(1)

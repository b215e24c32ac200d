"""Pretraining loop (port of ``mmearth_tpu/train/pretrain.py``; reference
main_pretrain.py:165-391 + engine_pretrain.py:21-122) on one device.

The loader feeds mmpack batches (pinned in its worker thread when it feeds a
card, then copied one batch ahead on a side stream: ``step.py::device_batches``).
With ``steps_per_dispatch`` k > 1, groups of k batches are stacked
(``_chunked_batches``, JAX ``pretrain.py:32-43``) and run as one dispatch of
``step.py::ChainedStep`` (on a card one replay of a captured CUDA graph); the
epoch's tail of fewer than k batches runs as single steps.  Every step adds
its loss to an on-device ``loss_sum`` and keeps its loss tensor, and both are
read once at the end of the epoch: the epoch loss is the exact mean over all
steps, with no per-step host synchronisation.  The loss is read for the log
and the non-finite check every ``PRINT_FREQ`` dispatches (a dispatch's every
step), and a non-finite loss stops the run (engine_pretrain.py:83-85).
With an output directory the run saves ``checkpoint-<epoch>.pth`` files and
resumes from the newest (``checkpoints/pth_io.py``; JAX
train/pretrain.py:177-215,304-306).
"""
from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..checkpoints import pth_io
from ..configs.config import PretrainConfig, RunConfig, model_size
from ..data.loader import PackedDataset, PackedLoader
from ..models.fcmae import FCMAE
from .optim import AdamW
from .schedule import warmup_cosine
from .step import ChainedStep, device_batches, pretrain_step

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


def _chunked_batches(it, k: int):
    """Group k batches into one stacked dict (leading axis k) for chained
    dispatch; tail batches are yielded unstacked (JAX ``pretrain.py:32-43``).
    numpy batches stack with numpy, tensors with torch (on their device)."""
    buf = []
    for b in it:
        buf.append(b)
        if len(buf) == k:
            yield {key: (torch.stack if isinstance(buf[0][key], torch.Tensor) else np.stack)(
                [bb[key] for bb in buf]) for key in buf[0]}
            buf = []
    yield from buf


def get_dataloader(cfg: PretrainConfig, split: str = "train", pin_memory: bool = False):
    """mmpack split ``<processed_dir or data_dir>/<split>``; ``pin_memory``:
    batches of pinned tensors, for a card."""
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
        order=cfg.data.order if is_train else "sequential", pin_memory=pin_memory)
    return ds, loader


class Dispatcher:
    """Pretraining steps on device batches, ``k`` a dispatch: each group of k
    through one ``ChainedStep`` (made on the first group, so its graphs live
    across epochs), fewer than k (an epoch's tail) as single steps."""

    def __init__(self, model: FCMAE, opt: AdamW, k: int, gen: torch.Generator,
                 random_crop: bool = True):
        self.model, self.opt, self.k, self.gen, self.random_crop = model, opt, k, gen, random_crop
        self.chained: ChainedStep | None = None

    def run(self, batches, step: int, loss_sum: torch.Tensor | None = None):
        """Yields each dispatch's step losses (n,); ``step`` is the first
        step's index for ``fold_in``."""
        for b in batches if self.k == 1 else _chunked_batches(batches, self.k):
            if b["sentinel2"].ndim == 5:
                if self.chained is None:
                    self.chained = ChainedStep(self.model, self.opt,
                                               {key: torch.empty_like(v) for key, v in b.items()},
                                               self.random_crop)
                self.chained.load(b)
                losses = self.chained(step, self.gen, loss_sum)[1]
            else:
                losses = pretrain_step(self.model, self.opt, b, step, self.gen,
                                       random_crop=self.random_crop,
                                       loss_sum=loss_sum)["loss"].float().reshape(1)
            step += len(losses)
            yield losses


def run_pretrain(cfg: PretrainConfig, device="cuda", args: dict | None = None):
    """Train; returns (model, history, optimizer), one history entry per epoch
    run with the exact mean ``loss``, ``steps`` (``chained_steps`` of them in
    chained dispatches), wall ``seconds`` and ``step_losses``.  ``args`` (the
    CLI's flags) is stored in every checkpoint."""
    dev = resolve_device(device)
    model = build_model(cfg, dev)
    ds, loader = get_dataloader(cfg, pin_memory=dev.type == "cuda")
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
    k = max(cfg.run.steps_per_dispatch, 1)
    print(f"device {dev}  effective batch size: {eff_batch}  actual lr: {lr:.2e}  "
          f"updates/epoch: {updates_per_epoch}  steps/dispatch: {k}  params: {n_params} "
          f"(encoder: {n_enc})")

    ckpt_dir = cfg.run.output_dir if (cfg.run.output_dir and cfg.run.save_ckpt) else None
    start_epoch = resume(cfg.run, model, opt, ckpt_dir)
    ckpt_args = dict(args or {})
    gen = torch.Generator(device=dev).manual_seed(cfg.run.seed)
    dispatcher = Dispatcher(model, opt, k, gen, cfg.data.random_crop)
    history = []
    step = start_epoch * len(loader)  # fold_in(gen, step) continues the run's draws
    for epoch in range(start_epoch, cfg.run.epochs):
        t0 = time.time()
        loader.set_epoch(epoch)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        step_losses = []
        for i, losses in enumerate(dispatcher.run(device_batches(loader, dev), step, loss_sum)):
            step_losses.append(losses)
            step += len(losses)
            if i % PRINT_FREQ == 0:
                values = losses.tolist()
                for v in values:
                    _check_finite(v)
                print(f"Epoch: [{epoch}] [{sum(map(len, step_losses)) - 1}/{len(loader)}] "
                      f"loss {values[-1]:.4f} lr {schedule(opt.count):.3e}")
        losses = torch.cat(step_losses).float().tolist() if step_losses else []
        for v in losses:
            _check_finite(v)
        mean = float(loss_sum) / max(len(losses), 1)
        seconds = time.time() - t0
        history.append({"epoch": epoch, "loss": mean, "steps": len(losses),
                        # a chained dispatch yields k >= 2 losses, a single step one
                        "chained_steps": sum(len(d) for d in step_losses if len(d) > 1),
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

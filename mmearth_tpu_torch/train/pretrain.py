"""Pretraining loop (port of ``mmearth_tpu/train/pretrain.py``; reference
main_pretrain.py:165-391 + engine_pretrain.py:21-122), one process a device.

The loader (``--loader mmpack``, ``grain`` or ``hdf5``: :func:`get_dataloader`)
feeds batches (pinned in its worker thread when it feeds a card, then copied
one batch ahead on a side stream: ``step.py::device_batches``).
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
train/pretrain.py:177-215,304-306), or from the JAX package's Orbax
checkpoints in the same directory where they are newer
(``checkpoints/orbax_io.py``).  With ``--log_dir`` each epoch's mean
loss, lr and last per-modality losses go to TensorBoard (``utils/logging.py``),
and with ``--wandb True`` to Weights & Biases with JAX's payload keys.

Under ``torchrun`` (``parallel/mesh.py::init_distributed``) each of the W
ranks trains on its GPU (``cuda:LOCAL_RANK``) from its shard of every split
(``shard=(rank, W)``), the effective batch and so the lr take the factor W,
and the step computes the global batch's loss, GRN statistics and update
(``train/step.py``): each rank's loss is the global one, so every rank
reports the same epoch mean and stops on the same non-finite step.  Rank 0
alone packs a missing split (the others wait), prints, logs to TensorBoard
and wandb and writes the checkpoints, each holding every rank's grain
stream position; the others wait for the file.
"""
from __future__ import annotations

import itertools
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..checkpoints import orbax_io, pth_io
from ..configs.config import PretrainConfig, RunConfig, model_size
from ..data.loader import PackedDataset, PackedLoader
from ..data.mmearth import MMEarthDataset
from ..data.pack import pack_mmearth
from ..models.fcmae import FCMAE
from ..parallel import mesh
from ..utils.logging import MetricLogger, TensorboardWriter, maybe_wandb
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


def build_model(cfg: PretrainConfig, device="cuda", process_group=None) -> FCMAE:
    """FCMAE for ``cfg``, initialised from ``cfg.run.seed`` (on the CPU, so
    the weights do not depend on the device), then moved to ``device``,
    with ``process_group`` given to the modules that take one."""
    dev = resolve_device(device)
    depths, dims = model_size(cfg.model.model)
    model = FCMAE(
        img_size=cfg.model.img_size, patch_size=cfg.model.patch_size, depths=depths, dims=dims,
        decoder_depth=cfg.model.decoder_depth, decoder_embed_dim=cfg.model.decoder_embed_dim,
        mask_ratio=cfg.model.mask_ratio, norm_pix_loss=cfg.model.norm_pix_loss,
        grn_group=cfg.data.batch_size if cfg.model.grn_scope == "per_device" else 0,
        block_impl=cfg.model.block_impl, sparse_impl=cfg.model.sparse_impl,
        sparse=cfg.model.sparse, use_orig_stem=cfg.model.use_orig_stem,
        gelu_approx=cfg.model.gelu_approx, loss_aggr=cfg.run.loss_aggr,
        loss_full=cfg.run.loss_full, inp_modalities=cfg.data.inp_modalities,
        out_modalities=cfg.data.out_modalities,
        dtype=torch.bfloat16 if cfg.run.use_bf16 else torch.float32,
    )
    model.init_weights(torch.Generator().manual_seed(cfg.run.seed))
    return mesh.set_process_group(model.to(dev), process_group)


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


class SampleCount:
    """``len()`` of a split: the samples an epoch draws from (the debug
    subset's 10 under ``--debug``), whatever the loader."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self):
        return self.n


def get_dataloader(cfg: PretrainConfig, split: str = "train", pin_memory: bool = False,
                   shard: tuple[int, int] = (0, 1)):
    """(samples, loader) of ``split`` for ``cfg.data.loader`` (JAX
    ``pretrain.py:70-133``): ``mmpack`` the packed split
    ``<processed_dir or data_dir>/<split>``, packed from the HDF5 at
    ``data_dir`` first where it is missing; ``grain`` the ArrayRecord pack
    ``<split>_arrayrecord`` (``_subset`` under ``--debug``), packed likewise;
    ``hdf5`` the HDF5 streamed.  ``--debug`` trains on the first 10 samples.
    ``pin_memory``: batches of pinned tensors, for a card.  ``shard=(rank,
    world)``: the rank's share of the samples (JAX's ``(process_index,
    process_count)``); the sample count stays the split's."""
    processed = Path(cfg.data.processed_dir or cfg.data.data_dir)
    debug = list(range(10)) if cfg.data.debug else None
    is_train = split == "train"
    common = dict(batch_size=cfg.data.batch_size, shuffle=is_train, drop_last=is_train,
                  seed=cfg.run.seed, pin_memory=pin_memory, shard=shard)
    if cfg.data.loader == "grain":
        from ..data.grain_pipeline import GrainLoader, pack_arrayrecord, require_array_record

        require_array_record()
        dest = processed / (split + "_arrayrecord" + ("_subset" if debug else ""))
        if not (dest / "meta.json").exists():
            src = MMEarthDataset(cfg.data.data_dir, cfg.data.modalities, split=split)
            print(f"packing split {split!r} -> {dest}")
            pack_arrayrecord(src, dest, indices=debug)
        loader = GrainLoader(dest, **common)
        return SampleCount(loader.count), loader
    if cfg.data.loader == "hdf5":
        from ..data.mmearth import HDF5StreamLoader, require_h5py

        require_h5py()
        ds = MMEarthDataset(cfg.data.data_dir, cfg.data.modalities, split=split)
        loader = HDF5StreamLoader(ds, indices=debug, **common)
        return SampleCount(len(loader.base_indices)), loader
    if cfg.data.loader != "mmpack":
        raise ValueError(f"unknown loader {cfg.data.loader!r}")
    path = processed / split
    if not (path / "meta.json").exists():
        pack_mmearth(cfg.data.data_dir, processed, cfg.data.modalities, splits=(split,))
    ds = PackedDataset(path)
    loader = PackedLoader(ds, indices=None if debug is None else debug[:len(ds)],
                          order=cfg.data.order if is_train else "sequential",
                          num_workers=cfg.data.num_workers, **common)
    return SampleCount(len(loader.base_indices)), loader


class Dispatcher:
    """Pretraining steps on device batches, ``k`` a dispatch: each group of k
    through one ``ChainedStep`` (made on the first group, so its graphs live
    across epochs), fewer than k (an epoch's tail) as single steps."""

    def __init__(self, model: FCMAE, opt: AdamW, k: int, gen: torch.Generator,
                 random_crop: bool = True):
        self.model, self.opt, self.k, self.gen, self.random_crop = model, opt, k, gen, random_crop
        self.chained: ChainedStep | None = None
        self.last_metrics: dict[str, torch.Tensor] = {}

    def run(self, batches, step: int, loss_sum: torch.Tensor | None = None):
        """Yields each dispatch's step losses (n,); ``step`` is the first
        step's index for ``fold_in``.  ``last_metrics`` holds the last step's
        on-device metrics (``loss_<modality>`` among them)."""
        for b in batches if self.k == 1 else _chunked_batches(batches, self.k):
            if b["sentinel2"].ndim == 5:
                if self.chained is None:
                    self.chained = ChainedStep(self.model, self.opt,
                                               {key: torch.empty_like(v) for key, v in b.items()},
                                               self.random_crop)
                self.chained.load(b)
                self.last_metrics, losses = self.chained(step, self.gen, loss_sum)
            else:
                self.last_metrics = pretrain_step(self.model, self.opt, b, step, self.gen,
                                                  random_crop=self.random_crop,
                                                  loss_sum=loss_sum)
                losses = self.last_metrics["loss"].float().reshape(1)
            step += len(losses)
            yield losses


def run_pretrain(cfg: PretrainConfig, device="cuda", args: dict | None = None):
    """Train; returns (model, history, optimizer), one history entry per epoch
    run with the exact mean ``loss``, ``steps`` (``chained_steps`` of them in
    chained dispatches), wall ``seconds`` and ``step_losses``.  ``args`` (the
    CLI's flags) is stored in every checkpoint; its ``dist_url`` and
    ``local_rank`` reach ``init_distributed``.  ``--loader grain`` trains
    off the loader's continuous stream, whose position rides in every
    checkpoint and is restored on resume (JAX ``pretrain.py:174-220``)."""
    args = dict(args or {})
    d = mesh.init_distributed(resolve_device(device), args.get("dist_url", "env://"),
                              int(args.get("local_rank", -1)))
    dev, group = d.device, d.group
    main = mesh.is_main(group)
    world = mesh.world_size(group)
    # made first: a missing tensorboardX stops the run before any work
    tb = TensorboardWriter(cfg.run.log_dir) if (cfg.run.log_dir and main) else None
    with mesh.main_first(group):  # a missing split is packed once
        ds, loader = get_dataloader(cfg, pin_memory=dev.type == "cuda",
                                    shard=(mesh.rank(group), world))
    model = build_model(cfg, dev, group)
    n_samples = len(ds)
    eff_batch = cfg.data.batch_size * cfg.optim.update_freq * world
    updates_per_epoch = max(n_samples // eff_batch, 1)
    lr = cfg.optim.absolute_lr(eff_batch)
    schedule = warmup_cosine(lr, cfg.optim.min_lr, cfg.run.epochs, cfg.optim.warmup_epochs,
                             updates_per_epoch)
    opt = AdamW(model.named_parameters(), schedule, cfg.optim.weight_decay, cfg.optim.betas,
                update_freq=cfg.optim.update_freq, clip_grad=cfg.optim.clip_grad,
                process_group=group)
    n_params = sum(p.numel() for p in model.parameters())
    n_enc = sum(p.numel() for p in model.encoder.parameters())
    k = max(cfg.run.steps_per_dispatch, 1)
    if main:
        print(f"device {dev}  world size {world}  loader {cfg.data.loader}  effective batch "
              f"size: {eff_batch}  actual lr: {lr:.2e}  updates/epoch: {updates_per_epoch}  "
              f"steps/dispatch: {k}  params: {n_params} (encoder: {n_enc})")

    grain_stream = cfg.data.loader == "grain"
    ckpt_dir = cfg.run.output_dir if (cfg.run.output_dir and cfg.run.save_ckpt) else None
    start_epoch = resume(cfg.run, model, opt, ckpt_dir, loader=loader if grain_stream else None,
                         rank=mesh.rank(group))
    mesh.broadcast_state(model, opt, group)
    gen = torch.Generator(device=dev).manual_seed(cfg.run.seed)
    dispatcher = Dispatcher(model, opt, k, gen, cfg.data.random_crop)
    wandb = (maybe_wandb(cfg.run.wandb, cfg.run.wandb_project, cfg.run.wandb_run_name,
                         vars(cfg.run)) if main else None)  # JAX pretrain.py:231
    history = []
    step = start_epoch * len(loader)  # fold_in(gen, step) continues the run's draws
    for epoch in range(start_epoch, cfg.run.epochs):
        t0 = time.time()
        logger = MetricLogger(PRINT_FREQ, header=f"Epoch: [{epoch}]", verbose=main)
        niter = len(loader)
        if grain_stream:
            # the continuous stream: len(loader) batches an "epoch", reshuffled
            # at its own epoch boundaries, its position kept across runs
            epoch_iter = itertools.islice(loader.iterator(), niter)
        else:
            loader.set_epoch(epoch)
            epoch_iter = iter(loader)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        step_losses = []
        dispatches = dispatcher.run(device_batches(epoch_iter, dev), step, loss_sum)
        for i, losses in logger.log_every(dispatches, total=niter // k + niter % k):
            step_losses.append(losses)
            step += len(losses)
            if i % PRINT_FREQ == 0:
                values = losses.tolist()
                for v in values:
                    _check_finite(v)
                logger.update(loss=values[-1], lr=schedule(opt.count))
        losses = torch.cat(step_losses).float().tolist() if step_losses else []
        for v in losses:
            _check_finite(v)
        mean = float(loss_sum) / max(len(losses), 1)
        seconds = time.time() - t0
        history.append({"epoch": epoch, "loss": mean, "steps": len(losses),
                        # a chained dispatch yields k >= 2 losses, a single step one
                        "chained_steps": sum(len(d) for d in step_losses if len(d) > 1),
                        "seconds": seconds, "step_losses": losses})
        if main:
            print(f"epoch {epoch} done  avg loss {mean:.4f}  ~"
                  f"{len(losses) * cfg.data.batch_size * world / max(seconds, 1e-9):.0f} "
                  "samples/s")
        # the exact epoch mean, the meters' lr, the last step's losses
        stats = {**logger.averages(), "loss": mean}
        last = dispatcher.last_metrics
        loss_dict = {key[5:]: float(v) for key, v in last.items() if key.startswith("loss_")}
        if tb is not None:
            tb.log({**stats, **{f"loss_{key}": v for key, v in loss_dict.items()}}, epoch + 1)
            tb.flush()
        if wandb is not None:  # JAX pretrain.py:298-303
            payload = {**{f"train_{key}": v for key, v in stats.items()}, "epoch": epoch}
            payload.update({f"train_loss_{key}": v for key, v in loss_dict.items()})
            if "log_vars" in last:
                payload.update({f"log_var_{i}": v
                                for i, v in enumerate(last["log_vars"].float().tolist())})
            wandb.log(payload)
        if ckpt_dir and ((epoch + 1) % cfg.run.save_ckpt_freq == 0 or epoch + 1 == cfg.run.epochs):
            states = mesh.gather_objects(loader.get_state(), group) if grain_stream else None
            if main:
                pth_io.save_checkpoint(ckpt_dir, epoch, model, opt, args,
                                       keep=cfg.run.save_ckpt_num,
                                       loader_state=states if world > 1 or states is None
                                       else states[0])
            mesh.barrier(group)
    if tb is not None:
        tb.close()
    mesh.close(d)
    return model, history, opt


def resume(run: RunConfig, model, opt, ckpt_dir, ema=None, loader=None, rank: int = 0) -> int:
    """Restore ``--resume`` (a ``.pth``, an output directory, or one of the
    JAX package's Orbax forms: ``pth_io.resolve``), else with
    ``--auto_resume`` the newest checkpoint of either format in
    ``ckpt_dir``; returns the epoch to start from: the checkpoint's epoch +
    1, or ``--start_epoch`` (nothing to resume, or a file that holds the
    model alone).  A ``loader`` with a stream position takes the
    checkpoint's (``rank``'s own where it holds one a rank; from an Orbax
    run, its grain position at the epoch's end, ``orbax_io.loader_position``)."""
    path = (pth_io.resolve(run.resume) if run.resume
            else pth_io.latest_checkpoint(ckpt_dir) if (ckpt_dir and run.auto_resume)
            else None)
    if path is None:
        return run.start_epoch
    orbax = orbax_io.is_step(path)
    epoch = (orbax_io.restore if orbax else pth_io.restore)(path, model, opt, ema)
    if epoch is None:
        print(f"resumed the params from {path}; epoch {run.start_epoch} from --start_epoch")
        return run.start_epoch
    if rank == 0:
        print(f"resumed from {path} (epoch {epoch}{', Orbax' if orbax else ''})")
    state = None
    if loader is not None and orbax:
        raw = orbax_io.find_loader_state(path, epoch, rank)
        state = None if raw is None else orbax_io.loader_position(raw, epoch, loader)
    elif loader is not None:
        state = pth_io.loader_state(path, rank)
    if state is not None:
        loader.set_state(state)
        if rank == 0:
            print("restored the loader's stream position (mid-stream resume)")
    return epoch + 1


def _check_finite(loss: float) -> None:
    if not math.isfinite(loss):
        print(f"Loss is {loss}, stopping training")  # engine_pretrain.py:83-85
        sys.exit(1)

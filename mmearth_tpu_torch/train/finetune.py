"""GEO-Bench finetuning and linear probe (port of
``mmearth_tpu/train/finetune.py``; reference main_finetune.py:427-806 +
engine_finetune.py:56-300), one process a device.

Models: the dense ConvNeXtV2 classifier and the ConvNeXtV2 U-Net, each
bootstrapped from a pretraining checkpoint (a ``.pth``, or the JAX
package's Orbax directory: encoder trunk overlaid, head re-initialised),
and the ResNet baselines (``resnet18/50`` and their U-Nets) from a foreign
``.pth`` (``checkpoints/foreign.py``: SeCo, GASSL, Satlas or ImageNet;
``fc`` re-initialised).  They train with the ``--opt`` family
(``train/optim.py::Optimizer``, AdamW by default) under layer-wise lr
decay (every ResNet param takes the top layer id, as in JAX).  The probe
freezes all but the head (the ResNet-UNet: all but its encoder).  The
ResNets' BatchNorm normalises with the batch's statistics and updates its
running ones in the training steps and uses the running ones in evaluation;
the EMA covers the params alone, as JAX's ``ema_params``.

Segmentation (``m-cashew-plant``, ``m-SA-crop-type``) runs the probe with the
staged unfreeze (reference main_finetune.py:598-619): from
``unfreeze_epoch`` on the whole model trains, under a fresh optimizer of the
same family whose update count, and so its warmup-cosine schedule, starts
again from 0, with
the step count that draws drop path; the EMA is kept.  That fresh optimizer
is the JAX package's documented deviation (train/finetune.py:11-13: torch's
``add_param_group`` would keep the decoder's moments), which the port
follows.  A U-Net run without ``--linear_probe True`` raises, as JAX's does.

Eval metrics are dataset-overall, from per-batch sufficient statistics
summed on the device and read once per split.  With an output directory the
run appends each epoch's record to ``log.txt``, saves
``checkpoint-<epoch>.pth`` every epoch and resumes from the newest
(``checkpoints/pth_io.py``; or from the JAX package's Orbax step where it is
newer, ``checkpoints/orbax_io.py``), writes the best val epoch's params to
``checkpoint-best.pth``, and scores the final test on the newest checkpoint
reloaded from disk; without one it scores the in-memory params, the JAX
package's documented path (train/finetune.py:276-377).  With ``--log_dir``
each epoch's record also goes to TensorBoard, and with ``--wandb True`` to
Weights & Biases (``utils/logging.py::maybe_wandb``).  Each epoch's record
in the history also counts the kernel launches of its training steps.

Under ``torchrun`` (``parallel/mesh.py``) each of the W ranks trains on its
GPU from its shard of every split: the effective batch and the lr take the
factor W, the model's process group makes the ResNets' BatchNorm and the
drop path draws the global batch's, the optimizer averages the gradients
over the ranks, and the reported losses are the ranks' mean (the global
batch's, every rank's batch being the same size).  ``evaluate`` sums its
metric statistics over the ranks once after its loop, so the score is the
whole split's and equals one process's (JAX's ``evaluate`` scores each
process's shard alone: ``ROADMAP.md``, "Kept on purpose").  Rank 0 alone
packs the splits (the others wait), prints, logs and writes; the others
wait for its files.
"""
from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import torch
from torch import nn

from .. import ops
from ..checkpoints import load_pretrained as lp
from ..checkpoints import orbax_io, pth_io
from ..checkpoints.foreign import load_foreign_resnet
from ..configs.config import FinetuneConfig, model_size
from ..data.geobench import NUM_CLASSES, TASK_CLASS, get_geobench_dataloaders
from ..eval.metrics import batch_stats_fn, metric_for
from ..losses.finetune import criterion_fn
from ..models.convnextv2 import ConvNeXtV2
from ..models.resnet import ResNet, ResNetUnet, build_resnet
from ..models.unet import ConvNeXtV2Unet
from ..parallel import mesh
from .ema import init_ema, update_ema
from ..utils.logging import MetricLogger, TensorboardWriter, maybe_wandb
from .optim import Optimizer, family, finetune_wd_mask, layer_lr_scales
from .pretrain import PRINT_FREQ, _check_finite, resolve_device, resume
from .schedule import warmup_cosine
from .step import fold_in, to_device

# the depths JAX's run_finetune gives the ResNets' layer decay (:171); every
# ResNet param takes the top layer id, so each scale is 1
RESNET_DEPTHS = (2, 2, 2, 2)


def build_finetune_model(cfg: FinetuneConfig, in_channels: int, nb_classes: int) -> nn.Module:
    """The model for ``cfg.model.model`` (the dense classifier, a
    ``convnextv2_unet_*`` U-Net, or a ResNet baseline), initialised on the
    CPU from ``cfg.run.seed``."""
    name = cfg.model.model
    dtype = torch.bfloat16 if cfg.run.use_bf16 else torch.float32
    if name.startswith("resnet"):
        model = build_resnet(name, num_classes=nb_classes, in_chans=in_channels, dtype=dtype)
    elif "unet" in name:
        depths, dims = model_size(name)
        model = ConvNeXtV2Unet(
            patch_size=cfg.model.patch_size, img_size=cfg.model.img_size, in_chans=in_channels,
            num_classes=nb_classes, depths=depths, dims=dims, drop_path_rate=cfg.drop_path,
            head_init_scale=cfg.head_init_scale, use_orig_stem=cfg.model.use_orig_stem,
            dtype=dtype)
    else:
        depths, dims = model_size(name)
        model = ConvNeXtV2(
            patch_size=cfg.model.patch_size, img_size=cfg.model.img_size, in_chans=in_channels,
            depths=depths, dims=dims, dtype=dtype, sparse=False, num_classes=nb_classes,
            drop_path_rate=cfg.drop_path, head_init_scale=cfg.head_init_scale,
            padding_mode=cfg.model.padding_mode, use_orig_stem=cfg.model.use_orig_stem)
    model.init_weights(torch.Generator().manual_seed(cfg.run.seed))
    return model


def bootstrap(model: nn.Module, path: str | Path, seed: int) -> None:
    """Load the checkpoint at ``path`` into ``model`` (JAX run_finetune
    :181-222): a pretraining checkpoint's encoder trunk onto the classifier
    or the U-Net, a foreign ResNet's backbone onto the ResNet or under the
    ResNet-UNet's ``encoder``; the head (``head`` or ``fc``) re-initialised,
    the ResNet-UNet's decoder kept as initialised."""
    if isinstance(model, ResNetUnet):
        enc = load_foreign_resnet(path, model.encoder.stage_sizes, model.encoder.bottleneck)
        state = lp.load_encoder_into(model.state_dict(), enc, where="encoder")
    else:
        if isinstance(model, ResNet):
            enc = load_foreign_resnet(path, model.stage_sizes, model.bottleneck)
        else:
            enc = lp.encoder_state_from_checkpoint(path, model.depths)
        state = lp.reinit_head(lp.load_encoder_into(model.state_dict(), enc), seed)
    model.load_state_dict(state)


def probe_trainable(model: nn.Module):
    """Which params the linear probe trains, by name."""
    if isinstance(model, ResNetUnet):
        return lp.resnet_unet_probe_trainable
    if isinstance(model, ResNet):
        return lp.resnet_probe_trainable
    if isinstance(model, ConvNeXtV2Unet):
        return lp.unet_probe_trainable
    return lp.classifier_probe_trainable


def full_trainable(model: nn.Module):
    """Which params a finetune (or the staged unfreeze) trains, by name."""
    return lp.unet_trainable if isinstance(model, ConvNeXtV2Unet) else lp.all_trainable


def make_optimizer(cfg: FinetuneConfig, model: nn.Module, trainable, n_train: int,
                   process_group=None) -> Optimizer:
    """Set ``requires_grad`` by ``trainable`` and return a fresh optimizer of
    the ``--opt`` family (layer-decayed lr scales, the finetune decay mask)
    over the trainable params, scheduled for ``n_train`` samples an epoch
    at the effective batch of every rank of ``process_group`` (JAX
    ``make_finetune_optimizer``), averaging the gradients over them.  On a
    grid (a ``mesh.Mesh``) the effective batch is that of its data ranks,
    and the optimizer is told which of ``model``'s params hold a shard."""
    for name, prm in model.named_parameters():
        prm.requires_grad_(trainable(name))
    grid = mesh.as_mesh(process_group)
    eff_batch = cfg.batch_size * cfg.optim.update_freq * grid.data
    updates_per_epoch = max(n_train // eff_batch, 1)
    schedule = warmup_cosine(cfg.optim.absolute_lr(eff_batch), cfg.optim.min_lr, cfg.run.epochs,
                             cfg.optim.warmup_epochs, updates_per_epoch)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    scales = (layer_lr_scales(named, cfg.optim.layer_decay,
                              getattr(model, "depths", RESNET_DEPTHS), cfg.optim.layer_decay_type)
              if cfg.optim.layer_decay != 1.0 else None)
    return Optimizer(named, schedule, cfg.optim.weight_decay, cfg.optim.betas,
                     eps=cfg.optim.opt_eps, update_freq=cfg.optim.update_freq,
                     clip_grad=cfg.optim.clip_grad, wd_mask=finetune_wd_mask(named),
                     lr_scales=scales, opt=cfg.optim.opt, momentum=cfg.optim.momentum,
                     process_group=process_group, shards=mesh.shard_keys(model))


def build_trainable(cfg: FinetuneConfig, in_channels: int, nb_classes: int, n_train: int,
                    device: torch.device, process_group=None) -> tuple[nn.Module, Optimizer]:
    """The model on ``device`` with ``process_group`` given to the modules
    that take one, bootstrapped from ``cfg.finetune`` when set, frozen as
    ``cfg.linear_probe`` says, and its optimizer over the trainable params
    (:func:`make_optimizer`).  On a grid (a ``mesh.Mesh``) the Blocks'
    ``pwconv1`` are then split over its model axis (``mesh.shard_params``)."""
    name = cfg.model.model
    if "unet" in name and not cfg.linear_probe:
        raise ValueError("U-Net runs use --linear_probe True (the staged unfreeze); see "
                         "helpers.py:800-804")
    model = build_finetune_model(cfg, in_channels, nb_classes)
    if cfg.finetune:
        if (isinstance(model, ConvNeXtV2) and cfg.model.padding_mode == "same"
                and not cfg.model.use_orig_stem and mesh.is_main(process_group)):
            print("note: finetuning a .pth with padding_mode='same'; upstream's dense model "
                  "pads as --padding_mode reference does (VALID initial conv, stride//2 "
                  "stem padding)")
        bootstrap(model, cfg.finetune, cfg.run.seed)
    mesh.shard_params(model.to(device), process_group)
    trainable = probe_trainable(model) if cfg.linear_probe else full_trainable(model)
    return model, make_optimizer(cfg, model, trainable, n_train, process_group)


def finetune_step(model: nn.Module, opt: Optimizer, batch, criterion, generator: torch.Generator,
                  bgr_to_rgb: bool = False, ema: dict | None = None,
                  ema_decay: float = 0.9999) -> torch.Tensor:
    """One training step (JAX make_finetune_step :73-119): forward with drop
    path drawn from ``generator`` (a ResNet in train mode normalises with the
    batch's statistics and updates its running ones), loss, backward,
    update, EMA (decay 1.0 on an accumulation-only step).  Returns the
    detached loss, with no host synchronisation."""
    x = batch["input"]
    if bgr_to_rgb:
        # imnet-pretrained weights expect RGB (reference engine_finetune.py:92-95)
        x = x[..., [2, 1, 0]]
    opt.zero_grad()
    loss = criterion(model(x, generator=generator), batch["label"])
    loss.backward()
    applied = opt.step()
    if ema is not None:
        update_ema(ema, model, ema_decay if applied else 1.0)
    return loss.detach()


@torch.no_grad()
def evaluate(model: nn.Module, loader, stats_fn, metric, device, bgr_to_rgb: bool = False,
             process_group=None):
    """The split's metric, in eval mode (the ResNets' running statistics):
    each batch's statistics summed on the device, then summed over the
    ranks of ``process_group`` (each loading its shard; the counts of
    batches may differ) in one all-reduce a statistic, read once at the
    end."""
    training = model.training
    model.eval()
    metric.reset()
    sums = {}
    for host_batch in loader:
        batch = to_device(host_batch, device)
        x = batch["input"][..., [2, 1, 0]] if bgr_to_rgb else batch["input"]
        for k, v in stats_fn(model(x).float(), batch["label"]).items():
            sums[k] = sums[k] + v if k in sums else v
    model.train(training)
    sums = {k: mesh.sum_(sums[k].contiguous(), process_group) for k in sorted(sums)}
    metric.update_stats({k: v.cpu().numpy() for k, v in sums.items()})
    return metric.compute()


def _with_params(model: nn.Module, params: dict) -> nn.Module:
    """A copy of ``model`` holding ``params`` (the EMA weights; the buffers,
    the ResNets' running statistics, are the model's)."""
    # the copy shares the model's process groups (a group cannot be copied)
    groups = [getattr(m, attr, None) for m in model.modules()
              for attr in ("process_group", "model_group")]
    out = copy.deepcopy(model, {id(g): g for g in groups if g is not None})
    out.load_state_dict({**out.state_dict(), **params})
    return out


def run_finetune(cfg: FinetuneConfig, loaders=None, task=None, device="cuda",
                 args: dict | None = None) -> dict:
    """Finetune (or probe); returns the per-epoch ``history`` (loss, steps,
    train and eval seconds, step losses, the val score, the kernel launches
    of the epoch's steps), the best val score, the final test score, where
    its params came from, the model and the optimizer (after a staged
    unfreeze, the fresh one).  ``args`` (the CLI's flags) is stored in every
    checkpoint; its ``dist_url`` and ``local_rank`` reach
    ``init_distributed``.  Under a process group, ``loaders`` given by the
    caller are the rank's shards."""
    family(cfg.optim.opt)  # an unsupported --opt raises before any work
    args = dict(args or {})
    d = mesh.init_distributed(resolve_device(device), args.get("dist_url", "env://"),
                              int(args.get("local_rank", -1)))
    dev, group = d.device, d.group
    main, world = mesh.is_main(group), mesh.world_size(group)
    # made first: a missing tensorboardX stops the run before any work
    tb = TensorboardWriter(cfg.run.log_dir) if (cfg.run.log_dir and main) else None
    if loaders is None:
        processed = (Path(cfg.processed_dir) if cfg.processed_dir
                     else Path(cfg.finetune).parent / "geobench_proc")
        with mesh.main_first(group):  # packed once
            loaders, task = get_geobench_dataloaders(
                cfg.data_set, processed, cfg.batch_size, partition=cfg.partition,
                geobench_bands_type=cfg.geobench_bands_type, seed=cfg.run.seed,
                num_workers=cfg.num_workers, shard=(mesh.rank(group), world))
    train_loader, val_loader, test_loader = loaders
    for split in (val_loader, test_loader):
        if split is not None and len(split.dataset) < world:
            # every rank must take part in evaluate's all-reduce with a batch
            raise ValueError(f"an eval split of {len(split.dataset)} samples cannot be "
                             f"shared by {world} ranks")
    in_channels = next(iter(train_loader))["input"].shape[-1]
    nb_classes = task.num_classes if task is not None else NUM_CLASSES[cfg.data_set]
    n_train = len(train_loader.dataset)
    # the staged unfreeze (JAX :307-316): segmentation probes only
    staged = TASK_CLASS[cfg.data_set] == "segmentation" and cfg.linear_probe

    model, opt = build_trainable(cfg, in_channels, nb_classes, n_train, dev, group)
    eff_batch = cfg.batch_size * cfg.optim.update_freq * world
    ema = init_ema(model) if cfg.model_ema else None
    criterion = criterion_fn(cfg.data_set, cfg.smoothing)
    stats_fn = batch_stats_fn(cfg.data_set, nb_classes)
    metric_name, metric = metric_for(cfg.data_set, nb_classes)
    bgr_to_rgb = cfg.use_imnet_weights and cfg.geobench_bands_type == "bgr"
    n_trainable = sum(p.numel() for p in model.parameters() if p.requires_grad)
    wandb = (maybe_wandb(cfg.run.wandb, cfg.run.wandb_project, cfg.run.wandb_run_name,
                         {"data_set": cfg.data_set, "model": cfg.model.model,
                          "linear_probe": cfg.linear_probe, **vars(cfg.run)}) if main else None)
    if main:
        print(f"device {dev}  world size {world}  number of params (trainable): {n_trainable}  "
              f"effective batch size: {eff_batch}  "
              f"actual lr: {cfg.optim.absolute_lr(eff_batch):.2e}")

    def eval_model():
        return _with_params(model, ema) if (ema is not None and cfg.model_ema_eval) else model

    out_dir = Path(cfg.run.output_dir) if cfg.run.output_dir else None
    ckpt_dir = out_dir if (out_dir and cfg.run.save_ckpt) else None
    # a resumed run's best val starts again from -inf, as JAX's does.  A
    # staged run's checkpoint from after the unfreeze holds the unfrozen
    # model's optimizer: the params and the EMA are restored first, to learn
    # the epoch, then the optimizer of that phase.  (JAX restores the state
    # and then unfreezes again, a fresh optimizer at the first resumed
    # epoch; the port resumes where the run stopped.)
    rank = mesh.rank(group)
    start_epoch = resume(cfg.run, model, None if staged else opt, ckpt_dir, ema, rank=rank)
    unfrozen = staged and start_epoch > cfg.unfreeze_epoch
    if unfrozen:
        opt = make_optimizer(cfg, model, full_trainable(model), n_train, group)
    if staged:
        start_epoch = resume(cfg.run, model, opt, ckpt_dir, ema, rank=rank)
    mesh.broadcast_state(model, opt, group)
    gen = torch.Generator(device=dev).manual_seed(cfg.run.seed)
    history, best_val, best = [], -float("inf"), None
    # fold_in(gen, step) continues the run's draws; the unfreeze restarts
    # the count, as JAX's fresh TrainState restarts the step its keys fold in
    step = (start_epoch - (cfg.unfreeze_epoch if unfrozen else 0)) * len(train_loader)
    for epoch in range(start_epoch, cfg.run.epochs):
        if staged and not unfrozen and epoch >= cfg.unfreeze_epoch:
            unfrozen = True
            opt = make_optimizer(cfg, model, full_trainable(model), n_train, group)
            step = 0
            if main:
                print(f"epoch {epoch}: unfreezing the full model (main_finetune.py:598-619), "
                      f"{sum(p.numel() for p in opt.params)} params now train")
        t0 = time.time()
        train_loader.set_epoch(epoch)
        launched = ops.launch_counts()
        step_losses = []
        logger = MetricLogger(PRINT_FREQ, header=f"Epoch: [{epoch}]", verbose=main)
        for i, host_batch in logger.log_every(train_loader, total=len(train_loader)):
            loss = finetune_step(model, opt, to_device(host_batch, dev), criterion,
                                 fold_in(gen, step), bgr_to_rgb, ema, cfg.model_ema_decay)
            step_losses.append(loss)
            step += 1
            if i % PRINT_FREQ == 0:
                value = float(mesh.mean(loss, group))
                _check_finite(value)
                logger.update(loss=value)
        # the ranks' mean: the global batch's loss
        losses = (mesh.mean(torch.stack(step_losses).float(), group).tolist()
                  if step_losses else [])
        for v in losses:
            _check_finite(v)
        launched = {k: n - launched[k] for k, n in ops.launch_counts().items()}
        train_seconds = time.time() - t0
        t1 = time.time()
        val_score = (evaluate(eval_model(), val_loader, stats_fn, metric, dev, bgr_to_rgb,
                              group) if val_loader is not None else float("nan"))
        mean = sum(losses) / max(len(losses), 1)
        history.append({"epoch": epoch, "loss": mean, "steps": len(losses),
                        "seconds": train_seconds, "eval_seconds": time.time() - t1,
                        "step_losses": losses, f"val_{metric_name}": val_score,
                        "lr": opt.lr_schedule(opt.count), "launches": launched})
        if main:
            print(f"epoch {epoch}  loss {mean:.4f}  val {metric_name} {val_score:.4f}  "
                  f"~{len(losses) * cfg.batch_size * world / max(train_seconds, 1e-9):.0f} "
                  "samples/s")
        # the reference's log_stats keys (main_finetune.py:680-704; its val
        # pass is "test_stats")
        log_stats = {"train_loss": mean, "train_lr": opt.lr_schedule(opt.count),
                     f"test_{metric_name}": val_score, "epoch": epoch,
                     "n_parameters": n_trainable}
        if wandb is not None:
            wandb.log(log_stats)
        if tb is not None:
            tb.log(log_stats, epoch + 1)
            tb.flush()
        if out_dir is not None and main:
            out_dir.mkdir(parents=True, exist_ok=True)
            with open(out_dir / "log.txt", "a", encoding="utf-8") as f:
                f.write(json.dumps(log_stats) + "\n")
        if val_score >= best_val:
            best_val = val_score
            if out_dir is not None and main:
                best = (epoch, {k: v.detach().cpu().clone()
                                for k, v in model.state_dict().items()})
        if ckpt_dir is not None:
            if main:
                pth_io.save_checkpoint(ckpt_dir, epoch, model, opt, args, ema,
                                       keep=cfg.run.save_ckpt_num)
            mesh.barrier(group)

    # the final test reloads the newest checkpoint from disk, as the
    # reference does (main_finetune.py:712-758), which also checks the file
    test_model, test_from = eval_model(), "memory"
    latest = pth_io.latest_checkpoint(ckpt_dir) if ckpt_dir is not None else None
    use_ema = ema is not None and cfg.model_ema_eval
    if latest is not None and orbax_io.is_step(latest):  # a JAX run's newer Orbax step
        tree = orbax_io.load_tree(latest)
        params = orbax_io.port_state(tree, model, use_ema and tree.get("ema_params") is not None)
        test_model, test_from = _with_params(model, params), f"disk (epoch {latest.name})"
    elif latest is not None:
        saved = pth_io.load(latest)
        params = saved["ema"] if use_ema else saved["model"]
        test_model, test_from = _with_params(model, params), f"disk (epoch {saved['epoch']})"
    test_score = (evaluate(test_model, test_loader, stats_fn, metric, dev, bgr_to_rgb, group)
                  if test_loader is not None else None)
    if tb is not None:
        tb.close()
    if main:
        print(f"final test {metric_name}: {test_score}  (params from {test_from})")
        print(f"best val {metric_name}: {best_val}")
    if best is not None:
        pth_io.write(out_dir / "checkpoint-best.pth",
                     {"model": best[1], "epoch": best[0], "args": args})
    if wandb is not None:
        wandb.finish()
    mesh.barrier(group)
    mesh.close(d)
    return {"history": history, f"best_val_{metric_name}": best_val,
            f"test_{metric_name}": test_score, "test_params_from": test_from, "model": model,
            "optimizer": opt}

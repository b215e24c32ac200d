#!/usr/bin/env python
"""The multi-rank dry run (port of ``__graft_entry__.py::dryrun_multichip``):
one step of each training path on a grid of ``world / 2`` data x 2 model
ranks (``parallel/mesh.py::create_mesh``), where the ``model`` axis splits
``pwconv1``, ``proj`` and the heads.

    torchrun --standalone --nproc_per_node 4 -m mmearth_tpu_torch.dryrun --device cpu
    torchrun --standalone --nproc_per_node 2 -m mmearth_tpu_torch.dryrun   # NCCL, a card a rank

As JAX's, on the arrays of its ``_synthetic_batch`` (``data.synthetic.
bench_batch``), 2 samples a rank:

  * the flagship pretraining step (atto 56/8, every output modality, f32,
    ``update_freq`` 2, a random 56-px crop of 64-px tiles) on the grid;
  * where the model axis is 2, the same step from the same weights and
    draws on the same ranks as a pure data grid (``create_mesh(world, 1)``),
    whose loss must equal the grid's within 1e-4 relative;
  * a chained dispatch of k = 2 steps (``train/step.py::ChainedStep``) of a
    mini FCMAE on the grid.  On a card that is a CUDA graph, which gloo's
    collectives cannot enter: with gloo ranks on CUDA it is skipped, and
    says so;
  * a step of the dense classifier with layer decay 0.9 and clip 1.0.

It runs under ``torchrun`` or in ranks whose group the caller made (a group
that exists is taken as it is); alone it is a grid of one.  Global rank 0
prints JAX's lines.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from .configs import modalities as M
from .data.synthetic import bench_batch
from .losses.finetune import criterion_fn
from .models.convnextv2 import ConvNeXtV2
from .models.fcmae import FCMAE
from .parallel import mesh
from .train.finetune import finetune_step
from .train.optim import AdamW, Optimizer, finetune_wd_mask, layer_lr_scales
from .train.pretrain import resolve_device
from .train.schedule import warmup_cosine
from .train.step import ChainedStep, fold_in, pretrain_step, to_device

MINI = dict(img_size=32, patch_size=8, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
            decoder_embed_dim=32, dtype=torch.float32)
MINI_OUT = ("sentinel2", "biome")


def _rows(arrays, grid: mesh.Mesh, dev) -> dict[str, torch.Tensor]:
    """The rank's rows (its data index's) of a global batch of arrays."""
    n = next(iter(arrays.values())).shape[0] // grid.data
    start, stop = mesh.shard_rows(n, grid.data_group)
    return to_device({k: np.ascontiguousarray(v[start:stop]) for k, v in arrays.items()}, dev)


def _flagship_step(grid: mesh.Mesh, batch_np, dev, schedule) -> tuple[float, int]:
    """The flagship's first (micro-)step on ``grid``: (loss, steps taken)."""
    model = FCMAE(img_size=56, patch_size=8, depths=(2, 2, 6, 2), dims=(40, 80, 160, 320),
                  loss_aggr="uncertainty", inp_modalities=M.INP_MODALITIES,
                  out_modalities=M.OUT_MODALITIES, dtype=torch.float32)
    model = mesh.shard_params(model.init_weights(torch.Generator().manual_seed(0)).to(dev), grid)
    opt = AdamW(model.named_parameters(), schedule, update_freq=2, process_group=grid,
                shards=mesh.shard_keys(model))
    gen = torch.Generator(device=dev).manual_seed(0)
    loss = float(pretrain_step(model, opt, _rows(batch_np, grid, dev), 0, gen)["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    return loss, 1


def _chained(grid: mesh.Mesh, world: int, dev, schedule) -> list[float]:
    """A ChainedStep of two on the mini FCMAE: its two losses."""
    model = FCMAE(**MINI, loss_aggr="uncertainty", inp_modalities=M.INP_MODALITIES,
                  out_modalities={k: M.OUT_MODALITIES[k] for k in MINI_OUT})
    model = mesh.shard_params(model.init_weights(torch.Generator().manual_seed(0)).to(dev), grid)
    opt = AdamW(model.named_parameters(), schedule, process_group=grid,
                shards=mesh.shard_keys(model))
    raw = {k: v for k, v in bench_batch(world * 2, 40).items() if k in MINI_OUT}
    batch = _rows(raw, grid, dev)
    ch = ChainedStep(model, opt, {k: v.expand(2, *v.shape).contiguous() for k, v in batch.items()})
    losses = ch(0, torch.Generator(device=dev).manual_seed(1))[1].tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite chained losses {losses}")
    return losses


def _finetune(grid: mesh.Mesh, world: int, dev, schedule) -> float:
    """A classifier step (layer decay 0.9, clip 1.0, JAX's finetune AdamW)."""
    depths = MINI["depths"]
    model = ConvNeXtV2(patch_size=8, img_size=32, in_chans=12, num_classes=10, depths=depths,
                       dims=MINI["dims"], sparse=False, dtype=torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    model = mesh.shard_params(model.to(dev), grid)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(world * 2, 32, 32, 12)).astype(np.float32)
    y = rng.integers(0, 10, size=(world * 2,)).astype(np.int64)
    named = list(model.named_parameters())
    opt = Optimizer(named, schedule, 0.3, (0.9, 0.999), clip_grad=1.0,
                    wd_mask=finetune_wd_mask(named), lr_scales=layer_lr_scales(named, 0.9, depths),
                    process_group=grid, shards=mesh.shard_keys(model))
    gen = torch.Generator(device=dev).manual_seed(2)
    loss = finetune_step(model, opt, _rows({"input": x, "label": y}, grid, dev),
                         criterion_fn("m-eurosat", 0.2), fold_in(gen, 0))
    loss = float(mesh.mean(loss, grid.data_group))
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite finetune loss {loss}")
    return loss


def dryrun_multichip(device="cuda") -> dict:
    """Run the dry run on this rank (see the module's docstring); returns its
    numbers: the grid, the flagship's loss on it (and on the pure data grid
    where the model axis is 2), the chained losses (None where skipped) and
    the finetune loss."""
    d = mesh.init_distributed(resolve_device(device))
    try:
        dev, group = d.device, d.group
        world = mesh.world_size(group)
        main = mesh.is_main(group)
        say = print if main else (lambda *a, **k: None)
        model_axis = 2 if world % 2 == 0 and world > 1 else 1
        grid = mesh.create_mesh(world // model_axis, model_axis, group)
        say(f"mesh: {{'data': {grid.data}, 'model': {grid.model}}}")
        schedule = warmup_cosine(1e-3, 0.0, 10, 1, 10)
        batch_np = bench_batch(world * 2, 64)
        out = {"mesh": (grid.data, grid.model)}
        loss, steps = _flagship_step(grid, batch_np, dev, schedule)
        say(f"dryrun_multichip({world}) pretrain OK  loss={loss:.4f}  step={steps}")
        out["loss"] = loss
        if model_axis > 1:
            # a wrong-but-finite split of the model axis would diverge here
            dp_loss, _ = _flagship_step(mesh.create_mesh(world, 1, group), batch_np, dev,
                                        schedule)
            if abs(dp_loss - loss) > 1e-4 * abs(dp_loss):
                raise AssertionError(f"model-axis mesh loss {loss} != pure-DP loss {dp_loss}")
            say(f"dryrun_multichip({world}) model-axis == pure-DP loss OK  "
                f"({loss:.6f} vs {dp_loss:.6f})")
            out["dp_loss"] = dp_loss
        if dev.type == "cuda" and group is not None and dist.get_backend(group) == "gloo":
            say(f"dryrun_multichip({world}) chained k=2 skipped: gloo's collectives cannot be "
                "captured in a CUDA graph (NCCL, one card a rank, can)")
            out["chained"] = None
        else:
            losses = _chained(grid, world, dev, schedule)
            say(f"dryrun_multichip({world}) chained k=2 OK  loss={losses[-1]:.4f}  step=2")
            out["chained"] = losses
        out["finetune_loss"] = _finetune(grid, world, dev, schedule)
        say(f"dryrun_multichip({world}) finetune OK  loss={out['finetune_loss']:.4f}")
        return out
    finally:
        mesh.close(d)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("multi-rank dry run (PyTorch/CUDA)")
    p.add_argument("--device", default="cuda", help="cuda (a card a rank) or cpu")
    return dryrun_multichip(p.parse_args(argv).device)


if __name__ == "__main__":
    main()

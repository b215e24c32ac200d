"""One rank of the four-process gloo runs of ``tests/test_torch_model_axis.py``.

``run(rank, world, port, case_dir)`` joins a gloo process group on
localhost, reads ``case_dir/inputs.pt`` (the weights, batches and masks the
test made with numpy, and a checkpoint of the one-process run), runs every
case of the port's ``model`` axis on a (2, 2) and a (1, 4) grid of the four
ranks, and writes what it saw to ``case_dir/rank<r>.pt``.  It imports torch
and the port only, so a spawned rank starts without JAX.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from mmearth_tpu_torch.checkpoints import orbax_io, pth_io
from mmearth_tpu_torch.dryrun import dryrun_multichip
from mmearth_tpu_torch.losses.finetune import criterion_fn
from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
from mmearth_tpu_torch.models.fcmae import FCMAE
from mmearth_tpu_torch.models.unet import ConvNeXtV2Unet
from mmearth_tpu_torch.parallel import mesh
from mmearth_tpu_torch.train.finetune import finetune_step
from mmearth_tpu_torch.train.optim import (AdamW, Optimizer, factored_dims, finetune_wd_mask,
                                           layer_lr_scales)
from mmearth_tpu_torch.train.step import ChainedStep, fold_in, pretrain_step

# (sparse_impl, block_impl) of the pretraining steps held against JAX
CASES = (("gathered", "auto"), ("gathered", "wholeblock"), ("masked_dense", "fused"),
         ("gathered", "remat"), ("gathered", "folded"))
FAMILIES = ("adamw", "lamb", "novograd")  # the classifier step's; LAMB and NovoGrad take norms
STEPS = (("batch", "mask"), ("batch2", "mask2"))
# the Adafactor leaf cases: (grid, update_freq), three updates each
LEAF_CASES = (("2x2", 1), ("1x4", 1), ("2x2", 2))
ADA_BATCHES = (("cls_x", "cls_y"), ("ada_x2", "ada_y2"))  # the Adafactor classifier's steps
ADA_SLOTS = ("v_row", "v_col", "v")


def rows(x, grid: mesh.Mesh):
    """The rank's rows (its data index's) of a global (N, ...) array, as a tensor."""
    n = x.shape[0] // grid.data
    start, stop = mesh.shard_rows(n, grid.data_group)
    return torch.as_tensor(np.ascontiguousarray(x[start:stop]))


def local(batch, grid):
    return {k: rows(v, grid) for k, v in batch.items()}


def fcmae(inp, grid, sparse_impl="gathered", block_impl="wholeblock"):
    model = FCMAE(**inp["kw"], sparse_impl=sparse_impl, block_impl=block_impl)
    model.load_state_dict(inp["sd"])
    return mesh.shard_params(model, grid)


def adamw(model, inp, grid):
    return AdamW(model.named_parameters(), lambda count: inp["lr"], inp["wd"], inp["betas"],
                 process_group=grid, shards=mesh.shard_keys(model))


def own(model) -> dict:
    """The rank's own params, shards as it holds them."""
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def whole_grads(model, grid) -> dict:
    """The gradients the optimizer applied (averaged over the ranks, and
    clipped where it clips), each split leaf's gathered over the model
    group."""
    split, out = mesh.shard_keys(model), {}
    for k, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad.detach().contiguous()
        if k in split:
            parts = [torch.empty_like(g) for _ in range(grid.model)]
            dist.all_gather(parts, g, group=grid.model_group)
            g = torch.cat(parts)
        out[k] = g.clone()
    return out


def steps(model, opt, inp, grid, which=STEPS, first: int = 0, grads=None) -> list[float]:
    """The steps of ``which`` on the rank's rows of the explicit masks; each
    step's whole gradients appended to ``grads`` where given."""
    gen = torch.Generator().manual_seed(0)
    losses = []
    for i, (b, m) in enumerate(which):
        losses.append(float(pretrain_step(model, opt, local(inp[b], grid), first + i, gen,
                                          random_crop=False, mask=rows(inp[m], grid))["loss"]))
        if grads is not None:
            grads.append(whole_grads(model, grid))
    return losses


def pretrain(inp, grid22, grid14, root: Path) -> dict:
    """Two AdamW steps of each case at (2, 2) and of ``wholeblock`` at (1, 4):
    the losses, the whole state gathered, the rank's own params and the
    names it holds split; the (2, 2) ``wholeblock`` state saved by rank 0."""
    out = {}
    for name, grid in (("2x2", grid22), ("1x4", grid14)):
        for sparse_impl, block_impl in (CASES if name == "2x2" else CASES[1:2]):
            model = fcmae(inp, grid, sparse_impl, block_impl)
            opt = adamw(model, inp, grid)
            grads = []
            losses = steps(model, opt, inp, grid, grads=grads)
            sd, opt_sd = mesh.gather_state(model, opt, grid)
            if name == "2x2" and block_impl == "wholeblock" and mesh.rank(grid) == 0:
                pth_io.save_checkpoint(root / "ckpt22", 1, sd, opt_sd, {})
            out[(name, block_impl)] = {
                "losses": losses, "grads": grads, "whole": {k: v.clone() for k, v in sd.items()},
                "own": own(model), "split": mesh.shard_keys(model),
                "shapes": {k: tuple(p.shape) for k, p in model.named_parameters()}}
    return out


def resume(inp, grid) -> dict:
    """(2, 2) from the one-process run's checkpoint after its first step,
    then its second step: the whole params and the update count."""
    model = fcmae(inp, grid)
    opt = adamw(model, inp, grid)
    epoch = pth_io.restore(inp["pth1"], model, opt, mesh=grid)
    grads = []
    losses = steps(model, opt, inp, grid, STEPS[1:], first=1, grads=grads)
    return {"epoch": epoch, "count": opt.count, "losses": losses, "grads": grads,
            "whole": mesh.gather_state(model, None, grid)[0]}


def orbax(inp, grid, root: Path) -> dict:
    """(2, 2) from the one-process run's Orbax step after its first step
    (``orbax_io.restore`` with the grid): the whole state as restored, rank
    0 writing it back to ``orbax22`` from the grid, then the second step's
    loss."""
    model = fcmae(inp, grid)
    opt = adamw(model, inp, grid)
    epoch = orbax_io.restore(inp["orbax1"], model, opt, mesh=grid)
    sd, opt_sd = mesh.gather_state(model, opt, grid)
    out = {"epoch": epoch, "count": opt.count, "mini_step": opt.mini_step,
           "whole": {k: v.clone() for k, v in sd.items()},
           "opt": {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
                   for k, v in opt_sd.items()}}
    if mesh.rank(grid) == 0:
        orbax_io.save(root / "orbax22", epoch, model, opt, {}, whole=(sd, opt_sd))
    out["losses"] = steps(model, opt, inp, grid, STEPS[1:], first=1)
    return out


def chained(inp, grid) -> dict:
    """Drawn crops and masks at (2, 2): two single steps, then a ChainedStep
    of two from the same state."""
    raw = local(inp["raw40"], grid)
    out = {}
    for kind in ("single", "chained"):
        model = fcmae(inp, grid)
        opt = adamw(model, inp, grid)
        gen = torch.Generator().manual_seed(5)
        losses, grads = [], []
        if kind == "single":
            for i in range(2):
                losses.append(float(pretrain_step(model, opt, raw, i, gen)["loss"]))
                grads.append(whole_grads(model, grid))
        else:
            ch = ChainedStep(model, opt, {k: v.expand(2, *v.shape) for k, v in raw.items()})
            losses = ch(0, gen)[1].tolist()
        out[kind] = {"losses": losses, "grads": grads, "own": own(model),
                     "whole": mesh.gather_state(model, None, grid)[0]}
    return out


def classifier_step(inp, grid, family: str = "adamw") -> tuple:
    """One classifier step on ``grid`` (a group or None for one process on
    the whole batch), layer decay 0.9 and clip 1.0: (model, loss)."""
    model = ConvNeXtV2(**inp["cls_kw"], sparse=False)
    model.load_state_dict(inp["cls_sd"])
    model = mesh.shard_params(model, grid)
    named = list(model.named_parameters())
    opt = Optimizer(named, lambda count: inp["cls_lr"], 0.3, (0.9, 0.999), clip_grad=1.0,
                    wd_mask=finetune_wd_mask(named),
                    lr_scales=layer_lr_scales(named, 0.9, inp["cls_kw"]["depths"]), opt=family,
                    process_group=grid, shards=mesh.shard_keys(model))
    grid = mesh.as_mesh(grid)
    batch = {"input": rows(inp["cls_x"], grid), "label": rows(inp["cls_y"], grid)}
    loss = finetune_step(model, opt, batch, criterion_fn("m-eurosat", 0.2), None)
    return model, float(mesh.mean(loss, grid.data_group))


def classifier(inp, grid) -> dict:
    """The classifier's step at (2, 2) under each of FAMILIES."""
    out = {}
    for family in FAMILIES:
        model, loss = classifier_step(inp, grid, family)
        out[family] = {"loss": loss, "split": mesh.shard_keys(model),
                       "grads": [whole_grads(model, grid)],
                       "whole": mesh.gather_state(model, None, grid)[0]}
    return out


def leaf_module() -> torch.nn.Module:
    """The leaves of the Adafactor cases, by the keys the sharding rule
    reads: ``a.pwconv1`` (flax (128, 512): split on optax's d0), ``b.proj``
    ((512, 256): split on d1), ``c.pred_x`` ((256, 384): factored whole, not
    as a shard of four), ``d.pred_y`` (a 1x1 conv, HWIO (1, 1, 128, 256)),
    their biases, and a replicated ``e.fc`` ((160, 160))."""
    lin, mods = torch.nn.Linear, torch.nn.ModuleDict
    return mods({"a": mods({"pwconv1": lin(128, 512)}), "b": mods({"proj": lin(512, 256)}),
                 "c": mods({"pred_x": lin(256, 384)}),
                 "d": mods({"pred_y": torch.nn.Conv2d(128, 256, 1)}),
                 "e": mods({"fc": lin(160, 160)})})


def adafactor_opt(model, grid, lr, update_freq=1, **kw) -> Optimizer:
    named = list(model.named_parameters())
    return Optimizer(named, lambda count: lr, 0.3, update_freq=update_freq,
                     wd_mask=finetune_wd_mask(named), opt="adafactor", process_group=grid,
                     shards=mesh.shard_keys(model), **kw)


def leaves(inp, grid, update_freq: int) -> dict:
    """Three Adafactor updates of the leaves (weight decay 0.3) on the
    whole gradients of ``inp``, each rank taking its slices: the whole
    params and optimizer state (``gather_state``), the split keys, and
    whether each leaf is factored on the whole leaf and as its shard."""
    model = leaf_module()
    model.load_state_dict(inp["leaf_sd"])
    model = mesh.shard_params(model, grid)
    split = mesh.shard_keys(model)
    opt = adafactor_opt(model, grid, inp["leaf_lr"], update_freq)
    for g in inp["leaf_grads"][:3 * update_freq]:
        for k, p in model.named_parameters():
            whole = g[k]
            p.grad = (whole.chunk(grid.model)[grid.model_index] if k in split else whole).clone()
        opt.step()
    sd, opt_sd = mesh.gather_state(model, opt, grid)
    return {"sd": sd, "opt": opt_sd, "split": split,
            "factored": {n: f is not None for n, f in zip(opt.names, opt.factored)},
            "shard_factored": {n: factored_dims(p.shape) is not None
                               for n, p in zip(opt.names, opt.params)},
            "count": opt.count}


def adafactor_classifier(inp, grid, steps=ADA_BATCHES, restore=None, save=None) -> dict:
    """The classifier at ``inp["ada_kw"]``'s widths under Adafactor (layer
    decay 0.9, weight decay 0.3, clip 1.0) on ``grid`` (None: one process on
    the whole batch), from ``inp["ada_sd"]`` or restored from the ``.pth``
    ``restore``: each step's loss, whole gradients, whole params and
    optimizer state; rank 0 writes each step's checkpoint to ``save``."""
    model = ConvNeXtV2(**inp["ada_kw"], sparse=False)
    model.load_state_dict(inp["ada_sd"])
    model = mesh.shard_params(model, grid)
    named = list(model.named_parameters())
    opt = adafactor_opt(model, grid, inp["cls_lr"], clip_grad=1.0,
                        lr_scales=layer_lr_scales(named, 0.9, inp["ada_kw"]["depths"]))
    if restore is not None:
        pth_io.restore(restore, model, opt, mesh=grid)
    g = mesh.as_mesh(grid)
    out = {"losses": [], "grads": [], "whole": [], "opt": [], "split": mesh.shard_keys(model),
           "factored": {n: f is not None for n, f in zip(opt.names, opt.factored)}}
    for i, (x, y) in enumerate(steps):
        loss = finetune_step(model, opt, {"input": rows(inp[x], g), "label": rows(inp[y], g)},
                             criterion_fn("m-eurosat", 0.2), None)
        out["losses"].append(float(mesh.mean(loss, g.data_group)))
        out["grads"].append(whole_grads(model, g))
        sd, opt_sd = mesh.gather_state(model, opt, grid)
        sd = {k: v.clone() for k, v in sd.items()}  # one process's are the live tensors
        opt_sd = {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
                  for k, v in opt_sd.items()}
        out["whole"].append(sd)
        out["opt"].append(opt_sd)
        if save is not None and mesh.rank(grid) == 0:
            pth_io.save_checkpoint(save, i, sd, opt_sd, {}, keep=0)
    out["count"] = opt.count
    return out


def adafactor(inp, grid22, grid14, root: Path) -> dict:
    """The Adafactor cases: the leaves at each of LEAF_CASES; the
    classifier's two steps at (2, 2), rank 0 saving them to ``ada22``; (1, 4)
    resumed from the one-process run's file after its first step."""
    grids = {"2x2": grid22, "1x4": grid14}
    return {"leaves": {c: leaves(inp, grids[c[0]], c[1]) for c in LEAF_CASES},
            "classifier": adafactor_classifier(inp, grid22, save=root / "ada22"),
            "resume": adafactor_classifier(inp, grid14, ADA_BATCHES[1:],
                                           restore=inp["ada_pth1"])}


def unet(inp, grid) -> dict:
    """One U-Net step with drop path at (2, 2): its encoder Blocks' pwconv1 split."""
    model = ConvNeXtV2Unet(**inp["unet_kw"])
    model.load_state_dict(inp["unet_sd"])
    model = mesh.shard_params(model, grid)
    opt = AdamW(model.named_parameters(), lambda count: inp["unet_lr"], process_group=grid,
                shards=mesh.shard_keys(model))
    batch = {"input": rows(inp["seg_x"], grid), "label": rows(inp["seg_y"], grid)}
    loss = finetune_step(model, opt, batch, criterion_fn("m-cashew-plant", 0.0),
                         fold_in(torch.Generator().manual_seed(3), 0))
    return {"loss": float(mesh.mean(loss, grid.data_group)), "split": mesh.shard_keys(model),
            "grads": [whole_grads(model, grid)], "whole": mesh.gather_state(model, None, grid)[0]}


def broadcast(inp, grid, r: int) -> dict:
    """Each rank's params and Adam mu moved by its rank, then
    ``broadcast_state``: what each rank holds after it; the same for the
    Adafactor leaves' slots."""
    model = fcmae(inp, grid)
    opt = adamw(model, inp, grid)
    leaf = mesh.shard_params(leaf_module(), grid)
    ada = adafactor_opt(leaf, grid, inp["leaf_lr"])
    with torch.no_grad():
        for t in (*opt.state_tensors(), *ada.state_tensors()):
            t.add_(r)
    mesh.broadcast_state(model, opt, grid)
    mesh.broadcast_state(leaf, ada, grid)
    return {"own": own(model), "mu": dict(zip(opt.names, (t.clone() for t in opt.mu))),
            "adafactor": {k: dict(zip(ada.names, (t.clone() for t in ada.slots[k])))
                          for k in ADA_SLOTS}}


def calls(inp, group) -> dict:
    """The collectives and groups ``create_mesh(4, 1)`` leads to, beside those
    of the plain group: the same, and no group made."""
    model = fcmae(inp, group)
    opt = adamw(model, inp, group)
    log: list = []
    names = ("new_group", "all_reduce", "broadcast")
    real = {n: getattr(dist, n) for n in names}

    def wrap(name):
        def f(*a, **kw):
            log.append((name, a[1] if name == "broadcast" else None,
                        kw.get("group") is group))
            return real[name](*a, **kw)
        return f

    out = {}
    for n in names:
        setattr(dist, n, wrap(n))
    try:
        for kind in ("group", "grid"):
            log.clear()
            g = group if kind == "group" else mesh.create_mesh(4, 1, group)
            grads = [torch.ones_like(p) for p in model.parameters()]
            mesh.all_reduce_grads(grads, g)
            mesh.broadcast_state(model, opt, g)
            out[kind] = list(log)
            if kind == "grid":
                out["grid_groups"] = (g.world is group, g.data_group is group, g.model_group)
    finally:
        for n in names:
            setattr(dist, n, real[n])
    return out


def run(rank: int, world: int, port: int, case_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    group = dist.group.WORLD
    root = Path(case_dir)
    inp = torch.load(root / "inputs.pt", weights_only=False)
    grid22 = mesh.create_mesh(2, 2, group)
    grid14 = mesh.create_mesh(1, 4, group)
    out = {"grid22": grid22[3:], "grid14": grid14[3:],
           "pretrain": pretrain(inp, grid22, grid14, root), "resume": resume(inp, grid22),
           "orbax": orbax(inp, grid22, root),
           "chained": chained(inp, grid22), "classifier": classifier(inp, grid22),
           "unet": unet(inp, grid22), "adafactor": adafactor(inp, grid22, grid14, root),
           "broadcast": broadcast(inp, grid22, rank),
           "calls": calls(inp, group), "dryrun": dryrun_multichip("cpu")}
    torch.save(out, root / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()

"""One rank of the two-process gloo runs of ``tests/test_torch_distributed.py``.

``run(rank, world, port, case_dir)`` joins a gloo process group on
localhost, reads ``case_dir/inputs.pt`` (the global batches, masks and
weights the test made with numpy), runs every case of the port at world
size ``world`` on its rank's rows, and writes what it saw to
``case_dir/rank<r>.pt``.  It imports torch and the port only, so a spawned
rank starts without JAX.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from mmearth_tpu_torch import main_finetune, main_pretrain
from mmearth_tpu_torch.checkpoints import pth_io
from mmearth_tpu_torch.data.loader import PackedDataset, PackedLoader
from mmearth_tpu_torch.eval.metrics import batch_stats_fn, metric_for
from mmearth_tpu_torch.losses.finetune import criterion_fn
from mmearth_tpu_torch.models.fcmae import FCMAE, zero_nan_inputs
from mmearth_tpu_torch.models.resnet import build_resnet
from mmearth_tpu_torch.models.unet import ConvNeXtV2Unet
from mmearth_tpu_torch.parallel import mesh
from mmearth_tpu_torch.train import finetune as tft
from mmearth_tpu_torch.train import pretrain as tpt
from mmearth_tpu_torch.train.optim import AdamW, Optimizer
from mmearth_tpu_torch.train.step import ChainedStep, draw, fold_in, pretrain_step

# (GRN scope, sparse_impl, block_impl, batch) of the FCMAE steps held against JAX
FCMAE_CASES = (("per_device", "gathered", "wholeblock", "batch"),
               ("per_device", "masked_dense", "fused", "batch"),
               ("global", "gathered", "wholeblock", "batch"),
               ("global", "masked_dense", "fused", "batch"),
               ("global", "gathered", "auto", "batch"),
               ("per_device", "gathered", "wholeblock", "nan_batch"))


def _rows(x, group):
    """The rank's rows of a global (N * world, ...) array, as a tensor."""
    n = x.shape[0] // mesh.world_size(group)
    start, stop = mesh.shard_rows(n, group)
    return torch.as_tensor(np.ascontiguousarray(x[start:stop]))


def _local(batch, group):
    return {k: _rows(v, group) for k, v in batch.items()}


def _fcmae(inp, scope, sparse_impl, block_impl, group, n_local):
    model = FCMAE(**inp["kw"], grn_group=n_local if scope == "per_device" else 0,
                  sparse_impl=sparse_impl, block_impl=block_impl)
    model.load_state_dict(inp["sd"])
    return mesh.set_process_group(model, group)


def _adamw(model, inp, group, update_freq=1):
    return AdamW(model.named_parameters(), lambda count: inp["lr"], inp["wd"], inp["betas"],
                 update_freq=update_freq, process_group=group)


def _state(model):
    return {"grads": {k: p.grad.detach().clone() for k, p in model.named_parameters()
                      if p.grad is not None},
            "params": {k: p.detach().clone() for k, p in model.named_parameters()}}


def fcmae_steps(inp, group) -> dict:
    """Each FCMAE case: one AdamW step on the rank's rows of the global batch
    and mask; the loss, the per-modality losses, the gradients the optimizer
    applied (averaged over the ranks) and the updated params.  The NaN batch
    also gives its rank-local loss (no group), for the naive mean."""
    out = {}
    mask = _rows(inp["mask"], group)
    n_local = mask.shape[0]
    for scope, sparse_impl, block_impl, which in FCMAE_CASES:
        model = _fcmae(inp, scope, sparse_impl, block_impl, group, n_local)
        opt = _adamw(model, inp, group)
        batch = _local(inp[which], group)
        gen = torch.Generator().manual_seed(0)
        m = pretrain_step(model, opt, batch, 0, gen, random_crop=False, mask=mask)
        res = {"loss": float(m["loss"]),
               "loss_dict": {k[5:]: float(v) for k, v in m.items() if k.startswith("loss_")},
               **_state(model)}
        if which == "nan_batch":
            local = _fcmae(inp, scope, sparse_impl, block_impl, None, n_local)
            with torch.no_grad():
                res["local_loss"] = float(local(zero_nan_inputs(batch), mask=mask)[0])
        out[(scope, sparse_impl, block_impl, which)] = res
    # update_freq 2: two micro-batches, one applied update
    model = _fcmae(inp, "per_device", "gathered", "wholeblock", group, n_local)
    opt = _adamw(model, inp, group, update_freq=2)
    gen = torch.Generator().manual_seed(0)
    losses = [float(pretrain_step(model, opt, _local(inp[b], group), i, gen, random_crop=False,
                                  mask=_rows(inp[m], group))["loss"])
              for i, (b, m) in enumerate((("batch", "mask"), ("batch2", "mask2")))]
    out["update_freq_2"] = {"losses": losses, "count": opt.count,
                            "params": _state(model)["params"]}
    return out


def chained(inp, group) -> dict:
    """Drawn crops and masks at W ranks: two single steps, then a
    ``ChainedStep`` of two from the same state; and one draw."""
    raw = _local(inp["raw64"], group)
    n_local = raw["sentinel2"].shape[0]
    out = {}
    for kind in ("single", "chained"):
        model = _fcmae(inp, "per_device", "gathered", "wholeblock", group, n_local)
        opt = _adamw(model, inp, group)
        gen = torch.Generator().manual_seed(5)
        if kind == "single":
            losses = [float(pretrain_step(model, opt, raw, i, gen)["loss"]) for i in range(2)]
        else:
            ch = ChainedStep(model, opt, {k: v.expand(2, *v.shape) for k, v in raw.items()})
            losses = ch(0, gen)[1].tolist()
        out[kind] = {"losses": losses, "params": _state(model)["params"]}
    d = draw(model, raw["sentinel2"], 3, torch.Generator().manual_seed(5), crop=True)
    out["draw"] = {"tops": d.tops, "lefts": d.lefts, "noise": d.noise}
    return out


def resnet_step(inp, group) -> dict:
    """A ResNet-18 classification step in train mode, in f64: the averaged
    gradients and the running statistics after it."""
    model = build_resnet("resnet18", num_classes=inp["ncls"], in_chans=3, dtype=torch.float64)
    model.load_state_dict(inp["resnet_sd"])
    model = mesh.set_process_group(model.double(), group).train()
    opt = Optimizer(model.named_parameters(), lambda count: 0.0, process_group=group)
    batch = {"input": _rows(inp["resnet_x"], group), "label": _rows(inp["resnet_y"], group)}
    loss = tft.finetune_step(model, opt, batch, criterion_fn("m-eurosat", 0.0), None)
    return {"loss": float(mesh.mean(loss, group)),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "buffers": {k: b.clone() for k, b in model.named_buffers()}}


def _unet(inp):
    model = ConvNeXtV2Unet(**inp["unet_kw"])
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def seg_step(inp, group) -> dict:
    """A segmentation step of a small U-Net with drop path, and the val
    split's Jaccard from the rank's shard."""
    model = mesh.set_process_group(_unet(inp), group)
    opt = tft.make_optimizer(inp["seg_cfg"], model, lambda name: True, 16, group)
    batch = {"input": _rows(inp["seg_x"], group), "label": _rows(inp["seg_y"], group)}
    gen = torch.Generator().manual_seed(3)
    loss = tft.finetune_step(model, opt, batch, criterion_fn("m-cashew-plant", 0.0),
                             fold_in(gen, 0))
    out = {"loss": float(mesh.mean(loss, group)), "params": _state(model)["params"]}
    loader = PackedLoader(PackedDataset(inp["seg_val"]), 2, shuffle=False, drop_last=False,
                          shard=(mesh.rank(group), mesh.world_size(group)))
    _, metric = metric_for("m-cashew-plant", inp["unet_kw"]["num_classes"])
    out["val_batches"] = len(loader)
    out["val_score"] = tft.evaluate(_unet(inp), loader,
                                    batch_stats_fn("m-cashew-plant",
                                                   inp["unet_kw"]["num_classes"]),
                                    metric, torch.device("cpu"), process_group=group)
    return out


class _Writes:
    """Counts ``pth_io.write`` calls on this rank."""

    def __init__(self):
        self.paths, self._write = [], pth_io.write

    def __enter__(self):
        def write(path, payload):
            self.paths.append(Path(path).name)
            return self._write(path, payload)

        pth_io.write = write
        return self

    def __exit__(self, *exc):
        pth_io.write = self._write


def drivers(inp, group) -> dict:
    """Both drivers at world size ``world``: ``main_pretrain`` on mmpack
    (its shards, history, params and the files this rank wrote), with
    ``--loader grain`` for two epochs, and one epoch then resumed; and
    ``main_finetune`` for one epoch."""
    root = Path(inp["root"])
    out = {}
    common = ["--model", "convnextv2_atto", "--input_size", "16", "--patch_size", "8",
              "--batch_size", "2", "--device", "cpu", "--use_bf16", "False",
              "--decoder_embed_dim", "16", "--warmup_epochs", "1", "--distributed", "True"]
    args = main_pretrain.get_args_parser().parse_args(
        common + ["--processed_dir", inp["mmpack"], "--epochs", "1",
                  "--output_dir", str(root / "pt_out")])
    cfg = main_pretrain.config_from_args(args)
    shard = (mesh.rank(group), mesh.world_size(group))
    _, loader = tpt.get_dataloader(cfg, shard=shard)
    loader.set_epoch(0)
    with _Writes() as w:
        model, history, _ = main_pretrain.main(args)
    out["pretrain"] = {"epoch_rows": [b.tolist() for b in loader._epoch_batches()],
                       "history": history, "writes": w.paths,
                       "params": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    grain = {}
    for name, epochs, dest in (("whole", 2, "a"), ("first", 1, "b"), ("rest", 2, "b")):
        args = main_pretrain.get_args_parser().parse_args(
            common + ["--data_dir", inp["h5"], "--processed_dir", str(root / f"grain_{dest}"),
                      "--loader", "grain", "--epochs", str(epochs),
                      "--output_dir", str(root / f"grain_{dest}" / "ckpt")])
        with _Writes() as w:
            _, history, _ = main_pretrain.main(args)
        grain[name] = {"history": history, "writes": w.paths}
    out["grain"] = grain
    args = main_finetune.get_args_parser().parse_args([
        "--device", "cpu", "--model", "convnextv2_atto", "--input_size", "56",
        "--patch_size", "8", "--data_set", "m-eurosat", "--processed_dir", inp["eurosat"],
        "--finetune", inp["pt_pth"], "--batch_size", "2", "--epochs", "1",
        "--use_bf16", "False", "--distributed", "True",
        "--output_dir", str(root / "ft_out")])
    with _Writes() as w:
        res = main_finetune.main(args)
    out["finetune"] = {"history": res["history"], "writes": w.paths,
                       "test": res["test_Accuracy"],
                       "params": {k: v.detach().clone()
                                  for k, v in res["model"].state_dict().items()}}
    return out


def run(rank: int, world: int, port: int, case_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    group = dist.group.WORLD
    inp = torch.load(Path(case_dir) / "inputs.pt", weights_only=False)
    out = {"fcmae": fcmae_steps(inp, group), "chained": chained(inp, group),
           "resnet": resnet_step(inp, group), "seg": seg_step(inp, group),
           "drivers": drivers(inp, group)}
    torch.save(out, Path(case_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()



"""The system under test: the port's FCMAE, its AdamW and its training loop
(``mmearth_tpu_torch.train.pretrain.Dispatcher``), built as the port's
``main_pretrain`` builds them, with the cell's weights loaded by name.

Every import of the port is inside a function, so that importing the
harness does not import the program.
"""
from __future__ import annotations

import torch


def build(cfg: dict, batch: int, device):
    """(model, named param shapes) of a config's ``model`` section, on
    ``device``, with the port's defaults for everything the section does
    not set.  The params are left as the constructor made them: the caller
    loads the cell's weights."""
    from mmearth_tpu_torch.models.fcmae import FCMAE
    from mmearth_tpu_torch.parallel import mesh

    m = cfg["model"]
    with torch.device(device):
        model = FCMAE(
            img_size=m["img_size"], patch_size=m["patch_size"], depths=tuple(m["depths"]),
            dims=tuple(m["dims"]), decoder_depth=m["decoder_depth"],
            decoder_embed_dim=m["decoder_embed_dim"], mask_ratio=m["mask_ratio"],
            norm_pix_loss=m["norm_pix_loss"],
            grn_group=batch if m["grn_scope"] == "per_device" else 0,
            block_impl=m["block_impl"], sparse_impl=m["sparse_impl"],
            loss_aggr=m["loss_aggr"],
            dtype={"bfloat16": torch.bfloat16, "float32": torch.float32}[m["dtype"]])
    mesh.set_process_group(model, None)
    return model, {k: tuple(p.shape) for k, p in model.named_parameters()}


@torch.no_grad()
def load_weights(model, weights: dict[str, torch.Tensor]) -> None:
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError("the weights do not match the model's parameters")
    for k, p in params.items():
        p.copy_(weights[k])


def optimizer(model, optim: dict):
    """The port's AdamW with the cell's lr held at its value."""
    from mmearth_tpu_torch.train.optim import AdamW

    lr = float(optim["lr"])
    return AdamW(model.named_parameters(), lambda count: lr, optim["weight_decay"],
                 tuple(optim["betas"]))


def dispatcher(model, opt, k: int, seed: int, device):
    from mmearth_tpu_torch.train.pretrain import Dispatcher

    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    return Dispatcher(model, opt, k, gen, random_crop=True)


def build_kernels() -> None:
    """Compile the port's kernels (each once per checkout, all at once)."""
    from mmearth_tpu_torch.ops import _build

    _build.build_all()


@torch.no_grad()
def state_norms(model, opt, weights: dict[str, torch.Tensor]) -> dict[str, dict[str, float]]:
    """Per leaf: the norm of AdamW's first moment and of the params' change
    from ``weights``, in float64."""
    params = dict(model.named_parameters())
    mu = dict(zip(opt.names, opt.mu))
    out = {"moment": {}, "change": {}}
    for k, p in params.items():
        out["moment"][k] = mu[k].double().norm()
        out["change"][k] = (p.double() - weights[k].double()).norm()
    return {kind: {k: float(v) for k, v in d.items()} for kind, d in out.items()}

"""Public model-hub entry point (port of ``mmearth_tpu/hub.py``; reference
hubconf.py:21-93).

``MPMAE(...)`` builds the dense ConvNeXtV2 classifier from a released MP-MAE
pretraining checkpoint: the decoder, mask token, projection and prediction
heads are dropped, the Minkowski kernels are remapped dense
(``checkpoints/load_pretrained.py``), and the head is fresh (normal, std
2e-5, zero bias, drawn as the JAX package draws it).  Under
``linear_probe`` every param but the head is frozen, as the finetune
CLI's probe freezes the classifier.

Checkpoint names and their download URLs mirror hubconf.py:82-87; pass a
local ``.pth`` via ``ckpt_path`` where there is no network.  The torch-hub
entry is ``mmearth_tpu_torch/hubconf.py``:

    torch.hub.load("<repo>/mmearth_tpu_torch", "MPMAE", source="local",
                   ckpt_path="pt.pth", num_classes=10, device="cuda")
"""
from __future__ import annotations

from pathlib import Path

import torch

from .checkpoints import load_pretrained as lp
from .configs.config import model_size
from .models.convnextv2 import ConvNeXtV2
from .train.pretrain import resolve_device

CKPT_URLS = {
    # released MP-MAE pretraining checkpoints (reference README.md:87-100)
    name: f"https://sid.erda.dk/share_redirect/g23YOnaaTp/pt-{name}.pth"
    for name in (
        "all_mod_atto_1M_64_uncertainty_56-8",
        "all_mod_atto_1M_128_uncertainty_112-16",
        "all_mod_atto_100k_128_uncertainty_112-16",
        "all_mod_tiny_1M_64_uncertainty_56-8",
        "all_mod_tiny_1M_128_uncertainty_112-16",
        "S2_atto_1M_64_uncertainty_56-8",
        "img_mod_atto_1M_64_uncertainty_56-8",
        "pix_mod_atto_1M_64_uncertainty_56-8",
        "rgb_atto_1M_64_uncertainty_56-8",
        "all_mod_atto_1M_64_unweighted_56-8",
    )
}


def MPMAE(
    model_name: str = "convnextv2_atto",
    ckpt_name: str = "all_mod_atto_1M_64_uncertainty_56-8",
    pretrained: bool = True,
    linear_probe: bool = False,
    ckpt_path: str | Path | None = None,
    num_classes: int = 1000,
    in_chans: int = 12,
    img_size: int = 56,
    patch_size: int = 8,
    seed: int = 0,
    device: str | torch.device = "cuda",
    **kwargs,
):
    """Returns (model, trainable_fn): the classifier on ``device`` with its
    params loaded (``requires_grad`` set by ``trainable_fn``), and
    ``trainable_fn(name) -> bool``, the params the probe (or the finetune)
    trains.  ``kwargs`` go to ``ConvNeXtV2`` (e.g. ``drop_path_rate``)."""
    dev = resolve_device(device)
    depths, dims = model_size(model_name)
    model = ConvNeXtV2(patch_size=patch_size, img_size=img_size, in_chans=in_chans,
                       depths=depths, dims=dims, sparse=False, num_classes=num_classes,
                       **kwargs)
    model.init_weights(torch.Generator().manual_seed(seed))
    if pretrained:
        if ckpt_path is None:
            ckpt_path = _download(CKPT_URLS[ckpt_name])
        enc = lp.encoder_state_from_checkpoint(ckpt_path, depths)
        model.load_state_dict(lp.reinit_head(lp.load_encoder_into(model.state_dict(), enc),
                                             seed))
    trainable_fn = lp.classifier_probe_trainable if linear_probe else lp.all_trainable
    for name, prm in model.named_parameters():
        prm.requires_grad_(trainable_fn(name))
    return model.to(dev), trainable_fn


def _download(url: str) -> Path:
    import urllib.request

    dest = Path.home() / ".cache" / "mmearth_tpu" / Path(url).name
    dest.parent.mkdir(parents=True, exist_ok=True)
    if not dest.exists():
        print(f"downloading {url} -> {dest}")
        urllib.request.urlretrieve(url, dest)
    return dest

"""Foreign baseline checkpoints: SeCo, GASSL, Satlas and ImageNet ResNets
(port of ``mmearth_tpu/checkpoints/foreign.py``; upstream's
``load_custom_checkpoint``, helpers.py:824-850 finetune branch, :892-933
linear-probe branch).

  * **seco** (SeasonalContrast, MoCo-style): drop the ``encoder_k``,
    ``queue`` and ``heads`` keys, then rename the rest by position onto the
    ResNet's ``state_dict()`` key order (the fc keys left out).
  * **gassl** (Geography-Aware SSL): unwrap ``state_dict``, strip the
    ``module.`` DDP prefix, then the same drop and positional rename.
  * **satlas** (U-Net only): positional rename onto the encoder's keys.
  * anything else is taken as a torchvision / ImageNet state dict whose
    keys are already canonical (its ``fc`` dropped).

The positional rename works because each of these registers the backbone in
torchvision's order, which :func:`torch_resnet_sd_keys` lists.  The port's
ResNet has torchvision's keys, so the remapped dict loads straight into it.
"""
from __future__ import annotations

from pathlib import Path
from typing import Mapping, Sequence

import torch


def _bn_keys(prefix: str) -> list[str]:
    # torch state_dict order: params (weight, bias) then buffers
    return [f"{prefix}.weight", f"{prefix}.bias", f"{prefix}.running_mean",
            f"{prefix}.running_var", f"{prefix}.num_batches_tracked"]


def torch_resnet_sd_keys(stage_sizes: Sequence[int], bottleneck: bool,
                         include_fc: bool = True) -> list[str]:
    """The ``state_dict()`` key order of a torchvision ResNet (registration
    order; parameters before buffers within each module)."""
    keys = ["conv1.weight"] + _bn_keys("bn1")
    for i, n_blocks in enumerate(stage_sizes, start=1):
        for j in range(n_blocks):
            for c in range(1, (3 if bottleneck else 2) + 1):
                keys += [f"layer{i}.{j}.conv{c}.weight"] + _bn_keys(f"layer{i}.{j}.bn{c}")
            # downsample: first block of layers 2-4, and layer1.0 of a
            # bottleneck (64 -> 256 channels)
            if j == 0 and (i > 1 or bottleneck):
                keys += [f"layer{i}.{j}.downsample.0.weight"]
                keys += _bn_keys(f"layer{i}.{j}.downsample.1")
    if include_fc:
        keys += ["fc.weight", "fc.bias"]
    return keys


def _drop_moco_keys(sd: Mapping) -> dict:
    """Drop momentum-encoder / queue / head keys (helpers.py:828-833)."""
    return {k: v for k, v in sd.items() if not any(t in k for t in ("encoder_k", "queue", "heads"))}


def positional_rename(sd: Mapping, target_keys: Sequence[str]) -> dict:
    """The checkpoint's values renamed onto ``target_keys`` by position
    (upstream's ``zip(model.state_dict().keys()[:-2], checkpoint.keys())``,
    helpers.py:839-841); checkpoint keys past the target list are dropped."""
    return {tk: sd[sk] for tk, sk in zip(target_keys, sd)}


def seco_remap(sd: Mapping, stage_sizes: Sequence[int], bottleneck: bool) -> dict:
    """SeCo MoCo checkpoint -> torchvision-keyed backbone (helpers.py:824-841)."""
    return positional_rename(_drop_moco_keys(sd),
                             torch_resnet_sd_keys(stage_sizes, bottleneck, include_fc=False))


def gassl_remap(sd: Mapping, stage_sizes: Sequence[int], bottleneck: bool) -> dict:
    """GASSL checkpoint -> torchvision-keyed backbone (helpers.py:843-855:
    unwrap ``state_dict``, strip ``module.``, drop, rename)."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    return positional_rename(_drop_moco_keys(sd),
                             torch_resnet_sd_keys(stage_sizes, bottleneck, include_fc=False))


def satlas_remap(sd: Mapping, stage_sizes: Sequence[int], bottleneck: bool) -> dict:
    """Satlas checkpoint -> the U-Net encoder's keys (helpers.py:924-928)."""
    return positional_rename(sd, torch_resnet_sd_keys(stage_sizes, bottleneck, include_fc=False))


def remap_foreign(sd: Mapping, finetune_path: str, stage_sizes: Sequence[int],
                  bottleneck: bool) -> dict:
    """Dispatch on a substring of the checkpoint's path, as upstream does
    (helpers.py:824, 843, 892, 918)."""
    if "seco" in finetune_path:
        return seco_remap(sd, stage_sizes, bottleneck)
    if "gassl" in finetune_path:
        return gassl_remap(sd, stage_sizes, bottleneck)
    if "satlas" in finetune_path:
        return satlas_remap(sd, stage_sizes, bottleneck)
    return {k: v for k, v in sd.items() if not k.startswith("fc.")}


def load_foreign_resnet(path: str | Path, stage_sizes: Sequence[int],
                        bottleneck: bool) -> dict[str, torch.Tensor]:
    """A foreign ResNet ``.pth`` as the torchvision-keyed backbone state
    dict (no ``fc``): floats as f32 tensors, ``num_batches_tracked`` as
    long.  Upstream's files hold more than tensors, so the file, the user's
    own, is not read with ``weights_only``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    if isinstance(ckpt, dict) and "state_dict" in ckpt:  # gassl wrapping
        ckpt = ckpt["state_dict"]
    sd = remap_foreign(ckpt, str(path), stage_sizes, bottleneck)
    return {k: torch.as_tensor(v).to(torch.long if k.endswith("num_batches_tracked")
                                     else torch.float32) for k, v in sd.items()}

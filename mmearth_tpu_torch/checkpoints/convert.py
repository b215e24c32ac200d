"""Weights carried across: a JAX FCMAE or classifier param tree -> the port's
state dict.

``from_jax_fcmae`` takes the flax param tree as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) and returns upstream's dense
FCMAE state dict, the keys and shapes ``mmearth_tpu.checkpoints.torch_convert
.flax_fcmae_to_torch(target="fcmae")`` emits, which strict-loads into
:class:`mmearth_tpu_torch.models.fcmae.FCMAE`.  Layouts: flax Dense ``(in,
out)`` -> Linear ``(out, in)``; conv HWIO -> OIHW (so the depthwise ``(7, 7,
1, C)`` -> ``(C, 1, 7, 7)``); GRN affines -> ``(1, 1, 1, C)``; the mask token
-> ``(1, D, 1, 1)``; the shared decoder written under every modality name.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

IMAGE_LEVEL = ("biome", "eco_region", "lat", "lon", "month", "era5")


def _oihw(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _block(tree: Mapping, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.dwconv.weight"] = _oihw(tree["dwconv"]["kernel"])
    sd[f"{prefix}.dwconv.bias"] = tree["dwconv"]["bias"]
    sd[f"{prefix}.norm.weight"] = tree["norm"]["scale"]
    sd[f"{prefix}.norm.bias"] = tree["norm"]["bias"]
    sd[f"{prefix}.pwconv1.weight"] = _t(tree["pwconv1"]["kernel"])
    sd[f"{prefix}.pwconv1.bias"] = tree["pwconv1"]["bias"]
    sd[f"{prefix}.grn.gamma"] = np.asarray(tree["grn"]["gamma"]).reshape(1, 1, 1, -1)
    sd[f"{prefix}.grn.beta"] = np.asarray(tree["grn"]["beta"]).reshape(1, 1, 1, -1)
    sd[f"{prefix}.pwconv2.weight"] = _t(tree["pwconv2"]["kernel"])
    sd[f"{prefix}.pwconv2.bias"] = tree["pwconv2"]["bias"]


def from_jax_encoder(enc: Mapping, depths: Sequence[int], prefix: str = "") -> dict:
    """JAX ConvNeXtV2 encoder params -> state dict of the port's ConvNeXtV2
    (numpy values, keys under ``prefix``).  The original stem (``stem_orig_*``
    in JAX) takes upstream's ``stem_orig.{0,1}`` keys."""
    sd: dict[str, np.ndarray] = {}
    p = prefix
    orig = "stem_orig_conv" in enc
    convs = ((("stem_orig_conv", "stem_orig.0"),) if orig else
             (("initial_conv_conv", "initial_conv.0"), ("stem_conv", "stem.0")))
    norms = ((("stem_orig_norm", "stem_orig.1"),) if orig else
             (("initial_conv_norm", "initial_conv.1"), ("stem_norm", "stem.1")))
    for name, key in convs:
        sd[f"{p}{key}.weight"] = _oihw(enc[name]["kernel"])
        sd[f"{p}{key}.bias"] = enc[name]["bias"]
    for name, key in norms:
        sd[f"{p}{key}.weight"] = enc[name]["scale"]
        sd[f"{p}{key}.bias"] = enc[name]["bias"]
    for i in range(3):
        sd[f"{p}downsample_layers.{i}.0.weight"] = enc[f"downsample_norms_{i}"]["scale"]
        sd[f"{p}downsample_layers.{i}.0.bias"] = enc[f"downsample_norms_{i}"]["bias"]
        sd[f"{p}downsample_layers.{i}.1.weight"] = _oihw(enc[f"downsample_convs_{i}"]["kernel"])
        sd[f"{p}downsample_layers.{i}.1.bias"] = enc[f"downsample_convs_{i}"]["bias"]
    for i, depth in enumerate(depths):
        for j in range(depth):
            _block(enc[f"stages_{i}_{j}"], f"{p}stages.{i}.{j}", sd)
    return sd


def from_jax_classifier(tree: Mapping, depths: Sequence[int]) -> dict[str, torch.Tensor]:
    """JAX dense ConvNeXtV2 classifier params -> state dict of the port's
    ``ConvNeXtV2(sparse=False)``: the encoder trunk plus ``norm.*`` and
    ``head.*``."""
    sd = from_jax_encoder(tree, depths)
    sd["norm.weight"] = tree["norm"]["scale"]
    sd["norm.bias"] = tree["norm"]["bias"]
    sd["head.weight"] = _t(tree["head"]["kernel"])
    sd["head.bias"] = tree["head"]["bias"]
    return to_tensors(sd)


def to_tensors(sd: Mapping) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def from_jax_fcmae(tree: Mapping, depths: Sequence[int], out_modalities: Sequence[str],
                   decoder_depth: int = 1) -> dict[str, torch.Tensor]:
    """JAX FCMAE params (numpy leaves) -> the port's (upstream's) state dict."""
    sd = from_jax_encoder(tree["encoder"], depths, prefix="encoder.")
    sd["proj.weight"] = _oihw(tree["proj"]["kernel"])
    sd["proj.bias"] = tree["proj"]["bias"]
    sd["mask_token"] = np.asarray(tree["mask_token"]).reshape(1, -1, 1, 1)
    for mod in out_modalities:
        for d in range(decoder_depth):
            _block(tree[f"decoder_{d}"], f"decoder_dict.{mod}.{d}", sd)
        head = tree[f"pred_{mod}"]
        sd[f"pred_dict.{mod}.weight"] = (_t(head["kernel"]) if mod in IMAGE_LEVEL
                                         else _oihw(head["kernel"]))
        sd[f"pred_dict.{mod}.bias"] = head["bias"]
    if "layer_norm_tmp" in tree:
        sd["layer_norm_tmp.weight"] = tree["layer_norm_tmp"]["scale"]
        sd["layer_norm_tmp.bias"] = tree["layer_norm_tmp"]["bias"]
    if "log_vars" in tree:
        sd["loss_fn.log_vars"] = tree["log_vars"]
    return to_tensors(sd)

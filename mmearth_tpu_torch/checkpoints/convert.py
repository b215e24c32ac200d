"""Weights carried across: a JAX FCMAE, classifier, U-Net or ResNet param tree
-> the port's state dict.

``from_jax_fcmae`` takes the flax param tree as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) and returns upstream's dense
FCMAE state dict, the keys and shapes ``mmearth_tpu.checkpoints.torch_convert
.flax_fcmae_to_torch(target="fcmae")`` emits, which strict-loads into
:class:`mmearth_tpu_torch.models.fcmae.FCMAE`.  Layouts: flax Dense ``(in,
out)`` -> Linear ``(out, in)``; conv HWIO -> OIHW (so the depthwise ``(7, 7,
1, C)`` -> ``(C, 1, 7, 7)``); GRN affines -> ``(1, 1, 1, C)``; the mask token
-> ``(1, D, 1, 1)``; the shared decoder written under every modality name.

The state dicts are whole.  A model split over a grid with a ``model`` axis
takes one as a whole model does, then ``parallel/mesh.py::shard_params``;
one already split takes it through ``mesh.place_state``.
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


def from_jax_unet(tree: Mapping, depths: Sequence[int],
                  use_orig_stem: bool = False) -> dict[str, torch.Tensor]:
    """JAX ConvNeXtV2Unet params -> state dict of the port's (upstream's)
    U-Net, the keys JAX ``flax_unet_to_torch(..., dims=dims)`` emits: the
    trunk, ``upsample_layers.{i}.{conv,norm}.*``,
    ``initial_conv_upsample.{0,1}.*``, the 1x1 ``head`` and upstream's
    unused final ``norm`` at its defaults (LN = 1/0)."""
    if use_orig_stem != ("stem_orig_conv" in tree):
        raise ValueError(f"use_orig_stem={use_orig_stem} but the tree's stem is "
                         f"{'the original' if 'stem_orig_conv' in tree else 'the dense'} one")
    sd = from_jax_encoder(tree, depths)
    for i in range(4):
        up = tree[f"upsample_layers_{i}"]
        sd[f"upsample_layers.{i}.conv.weight"] = _oihw(up["conv"]["kernel"])
        sd[f"upsample_layers.{i}.conv.bias"] = up["conv"]["bias"]
        sd[f"upsample_layers.{i}.norm.weight"] = up["norm"]["scale"]
        sd[f"upsample_layers.{i}.norm.bias"] = up["norm"]["bias"]
    sd["initial_conv_upsample.0.weight"] = _oihw(tree["initial_conv_upsample_conv"]["kernel"])
    sd["initial_conv_upsample.0.bias"] = tree["initial_conv_upsample_conv"]["bias"]
    sd["initial_conv_upsample.1.weight"] = tree["initial_conv_upsample_norm"]["scale"]
    sd["initial_conv_upsample.1.bias"] = tree["initial_conv_upsample_norm"]["bias"]
    sd["head.weight"] = _oihw(tree["head"]["kernel"])
    sd["head.bias"] = tree["head"]["bias"]
    last = np.shape(tree["downsample_convs_2"]["kernel"])[-1]
    sd["norm.weight"] = np.ones(last, np.float32)
    sd["norm.bias"] = np.zeros(last, np.float32)
    return to_tensors(sd)


def _bn(params: Mapping, stats: Mapping, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = params["scale"]
    sd[f"{prefix}.bias"] = params["bias"]
    sd[f"{prefix}.running_mean"] = stats["mean"]
    sd[f"{prefix}.running_var"] = stats["var"]
    sd[f"{prefix}.num_batches_tracked"] = None


def _resnet(params: Mapping, stats: Mapping, stage_sizes: Sequence[int], bottleneck: bool,
            prefix: str, sd: dict) -> None:
    sd[f"{prefix}conv1.weight"] = _oihw(params["stem_conv"]["kernel"])
    _bn(params["stem_norm"], stats["stem_norm"], f"{prefix}bn1", sd)
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            p, s, key = params[f"stage{i}_{j}"], stats[f"stage{i}_{j}"], f"{prefix}layer{i + 1}.{j}"
            for c in range(3 if bottleneck else 2):
                sd[f"{key}.conv{c + 1}.weight"] = _oihw(p[f"Conv_{c}"]["kernel"])
                _bn(p[f"BatchNorm_{c}"], s[f"BatchNorm_{c}"], f"{key}.bn{c + 1}", sd)
            if "downsample_conv" in p:
                sd[f"{key}.downsample.0.weight"] = _oihw(p["downsample_conv"]["kernel"])
                _bn(p["downsample_norm"], s["downsample_norm"], f"{key}.downsample.1", sd)
    if "fc" in params:
        sd[f"{prefix}fc.weight"] = _t(params["fc"]["kernel"])
        sd[f"{prefix}fc.bias"] = params["fc"]["bias"]


def from_jax_resnet(params: Mapping, batch_stats: Mapping, stage_sizes: Sequence[int],
                    bottleneck: bool) -> dict[str, torch.Tensor]:
    """JAX ResNet or ResNetUnet params and ``batch_stats`` -> the port's
    torchvision-keyed state dict (the reverse of JAX ``torch_resnet_to_flax``,
    foreign.py:118-152); the U-Net's encoder under ``encoder.``, its decoder
    blocks as ``decoder.{k}.{conv,norm}{0,1}.*`` and its
    ``segmentation_head``.  ``num_batches_tracked``, which flax does not
    keep, is 0."""
    sd: dict = {}
    if "encoder" in params:
        _resnet(params["encoder"], batch_stats["encoder"], stage_sizes, bottleneck, "encoder.", sd)
        k = 0
        while f"decoder_{k}" in params:
            p, s = params[f"decoder_{k}"], batch_stats[f"decoder_{k}"]
            for c in range(2):
                sd[f"decoder.{k}.conv{c}.weight"] = _oihw(p[f"conv{c}"]["kernel"])
                _bn(p[f"norm{c}"], s[f"norm{c}"], f"decoder.{k}.norm{c}", sd)
            k += 1
        sd["segmentation_head.weight"] = _oihw(params["segmentation_head"]["kernel"])
        sd["segmentation_head.bias"] = params["segmentation_head"]["bias"]
    else:
        _resnet(params, batch_stats, stage_sizes, bottleneck, "", sd)
    return {k: torch.zeros((), dtype=torch.long) if v is None
            else torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}

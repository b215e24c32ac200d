"""The port's state dicts -> the JAX package's flax param trees (numpy
leaves): the inverse of :mod:`.convert`'s ``from_jax_*``.

A copy of the JAX package's numpy-only torch -> flax converters, which its
drivers use for a ``.pth`` resume (``mmearth_tpu/checkpoints/
torch_convert.py``: ``torch_encoder_to_flax``, ``torch_unet_to_flax``,
``torch_fcmae_to_flax``; ``foreign.py``: ``torch_resnet_to_flax``), kept
here so that the port imports nothing of that package.  Layouts: Linear
``(out, in)`` -> Dense ``(in, out)``; conv OIHW -> HWIO; GRN affines ->
``(C,)``; the mask token -> ``(1, 1, 1, D)``; the shared decoder read from
the first output modality's keys.  ``torch_resnet_unet_to_flax`` adds the
ResNet-UNet's decoder and head, the inverse of ``convert.from_jax_resnet``'s
U-Net branch.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from .load_pretrained import remap_minkowski_keys

IMAGE_LEVEL = ("biome", "eco_region", "lat", "lon", "month", "era5")


def _conv_t2f(w) -> np.ndarray:  # OIHW -> HWIO
    return np.ascontiguousarray(np.asarray(w).transpose(2, 3, 1, 0))


def _set(tree: dict, path: tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.ascontiguousarray(value)


def _block_t2f(sd, prefix, tree, tpath):
    _set(tree, tpath + ("dwconv", "kernel"), _conv_t2f(sd[f"{prefix}.dwconv.weight"]))
    _set(tree, tpath + ("dwconv", "bias"), sd[f"{prefix}.dwconv.bias"])
    _set(tree, tpath + ("norm", "scale"), sd[f"{prefix}.norm.weight"])
    _set(tree, tpath + ("norm", "bias"), sd[f"{prefix}.norm.bias"])
    _set(tree, tpath + ("pwconv1", "kernel"), sd[f"{prefix}.pwconv1.weight"].T)
    _set(tree, tpath + ("pwconv1", "bias"), sd[f"{prefix}.pwconv1.bias"])
    _set(tree, tpath + ("grn", "gamma"), sd[f"{prefix}.grn.gamma"].reshape(-1))
    _set(tree, tpath + ("grn", "beta"), sd[f"{prefix}.grn.beta"].reshape(-1))
    _set(tree, tpath + ("pwconv2", "kernel"), sd[f"{prefix}.pwconv2.weight"].T)
    _set(tree, tpath + ("pwconv2", "bias"), sd[f"{prefix}.pwconv2.bias"])


def torch_encoder_to_flax(sd: Mapping, depths: Sequence[int], use_orig_stem: bool = False,
                          include_head: bool = True) -> dict:
    """Dense ConvNeXtV2 state dict -> flax ConvNeXtV2 param tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    tree: dict = {}
    if use_orig_stem:
        _set(tree, ("stem_orig_conv", "kernel"), _conv_t2f(sd["stem_orig.0.weight"]))
        _set(tree, ("stem_orig_conv", "bias"), sd["stem_orig.0.bias"])
        _set(tree, ("stem_orig_norm", "scale"), sd["stem_orig.1.weight"])
        _set(tree, ("stem_orig_norm", "bias"), sd["stem_orig.1.bias"])
    else:
        _set(tree, ("initial_conv_conv", "kernel"), _conv_t2f(sd["initial_conv.0.weight"]))
        _set(tree, ("initial_conv_conv", "bias"), sd["initial_conv.0.bias"])
        _set(tree, ("initial_conv_norm", "scale"), sd["initial_conv.1.weight"])
        _set(tree, ("initial_conv_norm", "bias"), sd["initial_conv.1.bias"])
        stem_w = sd["stem.0.weight"]
        if stem_w.ndim == 2:  # 1x1 depthwise stored squeezed
            stem_w = stem_w.reshape(*stem_w.shape, 1, 1)
        _set(tree, ("stem_conv", "kernel"), _conv_t2f(stem_w))
        _set(tree, ("stem_conv", "bias"), sd["stem.0.bias"])
        _set(tree, ("stem_norm", "scale"), sd["stem.1.weight"])
        _set(tree, ("stem_norm", "bias"), sd["stem.1.bias"])
    for i in range(3):
        _set(tree, (f"downsample_norms_{i}", "scale"), sd[f"downsample_layers.{i}.0.weight"])
        _set(tree, (f"downsample_norms_{i}", "bias"), sd[f"downsample_layers.{i}.0.bias"])
        _set(tree, (f"downsample_convs_{i}", "kernel"),
             _conv_t2f(sd[f"downsample_layers.{i}.1.weight"]))
        _set(tree, (f"downsample_convs_{i}", "bias"), sd[f"downsample_layers.{i}.1.bias"])
    for i, depth in enumerate(depths):
        for j in range(depth):
            _block_t2f(sd, f"stages.{i}.{j}", tree, (f"stages_{i}_{j}",))
    if include_head and "head.weight" in sd:
        _set(tree, ("norm", "scale"), sd["norm.weight"])
        _set(tree, ("norm", "bias"), sd["norm.bias"])
        _set(tree, ("head", "kernel"), sd["head.weight"].T)
        _set(tree, ("head", "bias"), sd["head.bias"])
    return tree


def torch_unet_to_flax(sd: Mapping, depths: Sequence[int], use_orig_stem: bool = False) -> dict:
    """ConvNeXtV2 U-Net state dict -> flax ConvNeXtV2Unet param tree; the
    upstream U-Net's unused final ``norm`` has no flax counterpart and is
    dropped."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    tree = torch_encoder_to_flax(sd, depths, use_orig_stem, include_head=False)
    for i in range(4):
        _set(tree, (f"upsample_layers_{i}", "conv", "kernel"),
             _conv_t2f(sd[f"upsample_layers.{i}.conv.weight"]))
        _set(tree, (f"upsample_layers_{i}", "conv", "bias"), sd[f"upsample_layers.{i}.conv.bias"])
        _set(tree, (f"upsample_layers_{i}", "norm", "scale"),
             sd[f"upsample_layers.{i}.norm.weight"])
        _set(tree, (f"upsample_layers_{i}", "norm", "bias"), sd[f"upsample_layers.{i}.norm.bias"])
    _set(tree, ("initial_conv_upsample_conv", "kernel"),
         _conv_t2f(sd["initial_conv_upsample.0.weight"]))
    _set(tree, ("initial_conv_upsample_conv", "bias"), sd["initial_conv_upsample.0.bias"])
    _set(tree, ("initial_conv_upsample_norm", "scale"), sd["initial_conv_upsample.1.weight"])
    _set(tree, ("initial_conv_upsample_norm", "bias"), sd["initial_conv_upsample.1.bias"])
    _set(tree, ("head", "kernel"), _conv_t2f(sd["head.weight"]))
    _set(tree, ("head", "bias"), sd["head.bias"])
    return tree


def torch_fcmae_to_flax(sd: Mapping, depths: Sequence[int], out_modalities: Sequence[str],
                        decoder_depth: int = 1, use_orig_stem: bool = False) -> dict:
    """FCMAE state dict (upstream's Minkowski one or the dense one) ->
    flax FCMAE param tree."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    if any(k.endswith("kernel") for k in sd):
        enc_sd = remap_minkowski_keys({k: v for k, v in sd.items() if k.startswith("encoder")})
    else:
        enc_sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    tree: dict = {"encoder": torch_encoder_to_flax(enc_sd, depths, use_orig_stem,
                                                   include_head=False)}
    _set(tree, ("proj", "kernel"), _conv_t2f(sd["proj.weight"]))
    _set(tree, ("proj", "bias"), sd["proj.bias"])
    _set(tree, ("mask_token",), sd["mask_token"].reshape(1, 1, 1, -1))
    first_mod = next(iter(out_modalities))
    for d in range(decoder_depth):
        _block_t2f(sd, f"decoder_dict.{first_mod}.{d}", tree, (f"decoder_{d}",))
    if "layer_norm_tmp.weight" in sd:
        _set(tree, ("layer_norm_tmp", "scale"), sd["layer_norm_tmp.weight"])
        _set(tree, ("layer_norm_tmp", "bias"), sd["layer_norm_tmp.bias"])
    for mod in out_modalities:
        w = sd[f"pred_dict.{mod}.weight"]
        _set(tree, (f"pred_{mod}", "kernel"), w.T if mod in IMAGE_LEVEL else _conv_t2f(w))
        _set(tree, (f"pred_{mod}", "bias"), sd[f"pred_dict.{mod}.bias"])
    if "loss_fn.log_vars" in sd:
        _set(tree, ("log_vars",), sd["loss_fn.log_vars"])
    return tree


def torch_resnet_to_flax(sd: Mapping, stage_sizes: Sequence[int],
                         bottleneck: bool) -> tuple[dict, dict]:
    """Torchvision-keyed ResNet state dict -> (params, batch_stats) trees of
    the flax ResNet; ``fc`` where the state dict has it."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    params: dict = {}
    stats: dict = {}

    def put_bn(tprefix: str, fname: str, scope_p: dict, scope_s: dict):
        scope_p[fname] = {"scale": sd[f"{tprefix}.weight"], "bias": sd[f"{tprefix}.bias"]}
        scope_s[fname] = {"mean": sd[f"{tprefix}.running_mean"],
                          "var": sd[f"{tprefix}.running_var"]}

    params["stem_conv"] = {"kernel": _conv_t2f(sd["conv1.weight"])}
    put_bn("bn1", "stem_norm", params, stats)
    n_convs = 3 if bottleneck else 2
    for i, n_blocks in enumerate(stage_sizes, start=1):
        for j in range(n_blocks):
            name = f"stage{i - 1}_{j}"
            bp: dict = {}
            bs: dict = {}
            for c in range(n_convs):
                bp[f"Conv_{c}"] = {"kernel": _conv_t2f(sd[f"layer{i}.{j}.conv{c + 1}.weight"])}
                put_bn(f"layer{i}.{j}.bn{c + 1}", f"BatchNorm_{c}", bp, bs)
            if f"layer{i}.{j}.downsample.0.weight" in sd:
                bp["downsample_conv"] = {
                    "kernel": _conv_t2f(sd[f"layer{i}.{j}.downsample.0.weight"])}
                put_bn(f"layer{i}.{j}.downsample.1", "downsample_norm", bp, bs)
            params[name] = bp
            stats[name] = bs
    if "fc.weight" in sd:
        params["fc"] = {"kernel": np.ascontiguousarray(sd["fc.weight"].T),
                        "bias": sd["fc.bias"]}
    return params, stats


def torch_resnet_unet_to_flax(sd: Mapping, stage_sizes: Sequence[int],
                              bottleneck: bool) -> tuple[dict, dict]:
    """ResNet-UNet state dict -> (params, batch_stats): the encoder under
    ``encoder``, each decoder block ``decoder_{k}`` (``conv{0,1}``,
    ``norm{0,1}``) and the ``segmentation_head``."""
    sd = {k: np.asarray(v) for k, v in sd.items()}
    enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    p_enc, s_enc = torch_resnet_to_flax(enc, stage_sizes, bottleneck)
    params: dict = {"encoder": p_enc}
    stats: dict = {"encoder": s_enc}
    k = 0
    while f"decoder.{k}.conv0.weight" in sd:
        bp, bs = {}, {}
        for c in range(2):
            pre = f"decoder.{k}.norm{c}"
            bp[f"conv{c}"] = {"kernel": _conv_t2f(sd[f"decoder.{k}.conv{c}.weight"])}
            bp[f"norm{c}"] = {"scale": sd[f"{pre}.weight"], "bias": sd[f"{pre}.bias"]}
            bs[f"norm{c}"] = {"mean": sd[f"{pre}.running_mean"], "var": sd[f"{pre}.running_var"]}
        params[f"decoder_{k}"], stats[f"decoder_{k}"] = bp, bs
        k += 1
    params["segmentation_head"] = {"kernel": _conv_t2f(sd["segmentation_head.weight"]),
                                   "bias": sd["segmentation_head.bias"]}
    return params, stats

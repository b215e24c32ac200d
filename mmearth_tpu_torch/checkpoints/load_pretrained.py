"""Bootstrap a finetune model from a pretraining checkpoint (port of
``mmearth_tpu/checkpoints/load_pretrained.py`` on torch state dicts; the
reference's ``load_custom_checkpoint``, helpers.py:799-1002).

Drop the decoder/mask_token/proj/pred/loss_fn weights, remap a raw
Minkowski encoder to the dense layout, overlay the encoder trunk onto the
model's state dict, re-init the head, and freeze per mode:

  * classifier finetune: everything trainable;
  * classifier linear probe: only the (new) head trains (helpers.py:984-1000);
    the final LayerNorm stays at init, as the reference freezes it untrained;
  * U-Net probe: the decoder and the head train, the encoder is frozen
    (helpers.py:941-955) until the staged unfreeze (main_finetune.py:598-619);
  * ResNet baselines (from :mod:`.foreign`): the probe trains ``fc``, or
    the ResNet-UNet's decoder and segmentation head.

Sources: a ``.pth``/``.pt`` holding ``{"model": state_dict}`` or a bare state
dict, with the encoder under ``encoder.*`` (an FCMAE checkpoint, dense or raw
Minkowski) or stripped (hub style); or the JAX package's Orbax directory (a
step or its payload, or a params directory: ``checkpoints/orbax_io.py``).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

_DECODER_SIDE = ("decoder", "mask_token", "proj", "pred", "loss_fn")
_TRUNK = ("initial_conv.", "stem.", "stem_orig.", "downsample_layers.", "stages.")


def load_pth(path) -> dict[str, np.ndarray]:
    """The state dict of a ``.pth``: ``ckpt["model"]`` or the bare dict, as
    numpy arrays.  The file is the user's own checkpoint; upstream's hold
    more than tensors (args, optimizer state), so it is not read with
    ``weights_only``."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in sd.items()}


def remap_minkowski_keys(sd: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """helpers.remap_checkpoint_keys (helpers.py:668-707), copied from JAX
    ``checkpoints/torch_convert.py``: strips ``encoder.``, turns Minkowski
    ``*.kernel`` tensors -- (K^2, in, out) convs and (K^2, C) depthwise --
    into OIHW (the final swap accounts for Minkowski's x-fastest kernel
    offsets), drops ``.ln.`` / ``.linear.`` path segments, flattens biases and
    unsqueezes the GRN affines."""
    new = OrderedDict()
    for k, v in sd.items():
        v = np.asarray(v)
        if k.startswith("encoder"):
            k = ".".join(k.split(".")[1:])
        if k.endswith("kernel"):
            base = ".".join(k.split(".")[:-1])
            new_k = base + ".weight"
            if v.ndim == 3:  # standard conv: (K^2, in, out)
                kv, in_dim, out_dim = v.shape
                ks = int(math.sqrt(kv))
                new[new_k] = v.transpose(2, 1, 0).reshape(out_dim, in_dim, ks, ks).swapaxes(3, 2)
            elif v.ndim == 2:  # depthwise: (K^2, C)
                kv, dim = v.shape
                ks = int(math.sqrt(kv))
                new[new_k] = v.transpose(1, 0).reshape(dim, 1, ks, ks).swapaxes(3, 2)
            else:  # K^2 == 1 kernels can arrive squeezed
                new[new_k] = v
            continue
        elif ".ln." in f".{k}." or ".linear." in f".{k}.":
            parts = k.split(".")
            if parts[-2] in ("ln", "linear"):  # helpers.py:689-692
                parts.pop(-2)
            new_k = ".".join(parts)
        else:
            new_k = k
        new[new_k] = v

    for k in list(new.keys()):
        v = new[k]
        if k.endswith("bias") and v.ndim != 1:
            new[k] = v.reshape(-1)
        elif "grn" in k:
            new[k] = np.expand_dims(np.expand_dims(v, 0), 1)
    return dict(new)


def encoder_state_from_checkpoint(path: str | Path,
                                  depths: Sequence[int]) -> dict[str, torch.Tensor]:
    """The encoder trunk of a pretraining checkpoint (stem or original stem,
    downsamples and the blocks of ``depths``) as a dense state dict: GRN
    affines (1, 1, 1, C) and a 1x1 stem conv (depthwise (C, 1, 1, 1), or the
    original stem's (C, in, 1, 1)) whatever shape they were stored in, as
    JAX ``encoder_tree_from_checkpoint`` + ``torch_encoder_to_flax`` read
    them."""
    path = Path(path)
    if path.suffix not in (".pth", ".pt") and path.is_dir():
        enc = _orbax_encoder(path, depths)
    else:
        sd = load_pth(path)
        enc = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
        if not enc:  # an already stripped dense checkpoint (hub style)
            enc = {k: v for k, v in sd.items() if not any(t in k for t in _DECODER_SIDE)}
        if any(k.endswith("kernel") for k in enc):
            enc = remap_minkowski_keys(enc)
    blocks = {f"stages.{i}.{j}." for i, d in enumerate(depths) for j in range(d)}
    out = {}
    for k, v in enc.items():
        if any(t in k for t in _DECODER_SIDE) or not k.startswith(_TRUNK):
            continue
        if k.startswith("stages.") and ".".join(k.split(".")[:3]) + "." not in blocks:
            continue
        if ".grn." in k:
            v = v.reshape(1, 1, 1, -1)
        elif k in ("stem.0.weight", "stem_orig.0.weight") and v.ndim == 2:  # 1x1, squeezed
            v = v.reshape(*v.shape, 1, 1)
        out[k] = torch.from_numpy(np.array(v, dtype=np.float32))
    return out


def _orbax_encoder(path: Path, depths: Sequence[int]) -> dict[str, np.ndarray]:
    """The encoder of the JAX package's Orbax checkpoint at ``path`` (a
    step directory or its payload: ``{params: {encoder: ...}}``, or a raw
    params directory), in the port's layout (JAX
    ``encoder_tree_from_checkpoint``)."""
    from .convert import from_jax_encoder
    from .orbax_io import load_params, numpy_tree

    tree = numpy_tree(load_params(path))
    if "params" in tree:
        tree = tree["params"]
    if "encoder" in tree:
        tree = tree["encoder"]
    return from_jax_encoder(tree, depths)


def load_encoder_into(state: dict[str, torch.Tensor], encoder: Mapping[str, torch.Tensor],
                      where: str = "") -> dict[str, torch.Tensor]:
    """Overlay encoder weights onto a freshly initialised model's state dict:
    at the top (the classifier and the U-Net share the trunk's key names,
    the ResNet classifier the backbone's) or under ``where`` (``"encoder"``:
    the ResNet-UNet's backbone).  Every shape must match; keys the model
    does not have are printed and skipped."""
    state = dict(state)
    prefix = f"{where}." if where else ""
    for k, v in encoder.items():
        key = prefix + k
        if key not in state:
            print(f"skipping unexpected checkpoint key {key}")
            continue
        if tuple(state[key].shape) != tuple(v.shape):
            raise ValueError(f"{key}: model {tuple(state[key].shape)} vs checkpoint "
                             f"{tuple(v.shape)}")
        state[key] = v.to(state[key].dtype)
    return state


def reinit_head(state: dict[str, torch.Tensor], seed: int = 0) -> dict[str, torch.Tensor]:
    """Head re-init for finetune/probe (helpers.py:857-867, 993-1000): normal
    std 2e-5 (trunc-normal at this scale), zero bias, for ``head`` (the
    classifier's Linear, the U-Net's 1x1 conv) and ``fc`` (the ResNet
    classifier's).  Drawn with numpy in the JAX kernel's shape ((in, out),
    or (1, 1, in, out) for the conv) and transposed, so the weights are
    bit-identical to the JAX package's."""
    state = dict(state)
    for name in ("head", "fc"):
        if f"{name}.weight" not in state:
            continue
        shape = tuple(state[f"{name}.weight"].shape)  # (out, in) or (out, in, 1, 1)
        order = (1, 0) if len(shape) == 2 else (2, 3, 1, 0)
        draw = np.random.default_rng(seed).standard_normal(tuple(shape[i] for i in order))
        w = (draw * 2e-5).astype(np.float32).transpose(np.argsort(order))
        state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
        state[f"{name}.bias"] = torch.zeros_like(state[f"{name}.bias"])
    return state


# ---------------------------------------------------------------------------
# trainable params (requires_grad), by name
# ---------------------------------------------------------------------------
def classifier_probe_trainable(name: str) -> bool:
    return name.startswith("head")


def unet_probe_trainable(name: str) -> bool:
    """The U-Net probe trains the decoder and the head (helpers.py:941-955)."""
    return name.startswith(("head", "upsample_layers", "initial_conv_upsample"))


def unet_trainable(name: str) -> bool:
    """Every U-Net param but upstream's final ``norm``, which the forward
    never reads (the JAX model has none)."""
    return not name.startswith("norm.")


def resnet_probe_trainable(name: str) -> bool:
    """The ResNet classifier's probe trains ``fc`` (helpers.py:968-983)."""
    return name.startswith("fc")


def resnet_unet_probe_trainable(name: str) -> bool:
    """The ResNet-UNet's probe trains all but the encoder (helpers.py:957-966)."""
    return not name.startswith("encoder")


def all_trainable(name: str) -> bool:
    return True

"""The cell's weights, made from the seed on the device in a few large calls.

The init rules are those of the MP-MAE FCMAE (ConvNeXtV2 with sparse
blocks): the stem's depthwise conv, every encoder Block's convs and
products, the projection, the decoder's depthwise conv and the pixel heads
draw a normal truncated to two sigma with std 1; the initial conv, the
downsamples, the decoder's products, the mask token and the image-level
heads a normal with std 0.02; biases, GRN affines and the uncertainty
weights start at 0; LayerNorm scales at 1.
"""
from __future__ import annotations

import math
import re

import torch
from reference.model import PIXEL_HEADS

TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]
_TRUNC1 = (r"^encoder\.stem\.0\.weight$", r"^encoder\.stages\.\d+\.\d+\.(dwconv|pwconv1|pwconv2)"
           r"\.weight$", r"^proj\.weight$", r"^decoder_dict\.[^.]+\.\d+\.dwconv\.weight$")
_ZEROS = (r"\.bias$", r"\.gamma$", r"\.beta$", r"^loss_fn\.log_vars$")


def init_kind(name: str, shape) -> str:
    """"trunc1", "normal02", "zeros" or "ones" for a parameter name."""
    if any(re.search(p, name) for p in _ZEROS):
        return "zeros"
    if len(shape) == 1:
        return "ones"  # LayerNorm scales
    if any(re.search(p, name) for p in _TRUNC1):
        return "trunc1"
    m = re.match(r"^pred_dict\.([^.]+)\.weight$", name)
    if m and m.group(1) in PIXEL_HEADS:
        return "trunc1"
    return "normal02"


def make_weights(shapes: dict[str, tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """f32 tensors of ``shapes`` (name -> shape) from ``seed``: one draw of
    uniforms for every truncated normal (by the inverse CDF) and one of
    normals, cut into the leaves."""
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    sizes = {k: math.prod(s) for k, s in shapes.items()}
    total = sum(sizes.values())
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    trunc = torch.erfinv((u * (1 - 2 * lo) + lo) * 2 - 1).mul_(math.sqrt(2) / TRUNC_STD)
    trunc.clamp_(-2 / TRUNC_STD, 2 / TRUNC_STD)
    normal = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = sizes[name]
        kind = init_kind(name, shape)
        if kind == "trunc1":
            t = trunc[at:at + n].clone()
        elif kind == "normal02":
            t = normal[at:at + n] * 0.02
        elif kind == "zeros":
            t = torch.zeros(n, device=device)
        else:
            t = torch.ones(n, device=device)
        out[name] = t.reshape(shape)
        at += n
    return out

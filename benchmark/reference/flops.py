"""The model FLOPs of one pretraining step, counted through the reference.

``torch.utils.flop_counter.FlopCounterMode`` around one forward and
backward of :func:`.model.loss` on the CPU: the matrix products and
convolutions dispatched (2 * M * N * K a product, 2 * outputs * taps * input
channels a group for a convolution, the backward's included), the
convention of published MFU figures.  Elementwise work is not counted, and
neither is the depthwise taps' gradient, which the definition computes as
49 shifted products summed (:class:`.model.DWConv7`).  The count is linear
in the batch; it is taken at a batch of 2 and given per sample.

    python3 -m reference.flops benchmark/configs/atto56.json   # from benchmark/
"""
from __future__ import annotations

import json
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from .model import Shape, loss
from .precision import F32

COUNT_BATCH = 2


def param_shapes(s: Shape) -> dict[str, tuple]:
    """The FCMAE's parameters by name (the program's names), in order."""
    d0, out = s.dims[0], {}
    st = s.stem_stride
    out.update({"encoder.initial_conv.0.weight": (d0, s.in_chans, 3, 3),
                "encoder.initial_conv.0.bias": (d0,),
                "encoder.initial_conv.1.weight": (d0,), "encoder.initial_conv.1.bias": (d0,),
                "encoder.stem.0.weight": (d0, 1, st, st), "encoder.stem.0.bias": (d0,),
                "encoder.stem.1.weight": (d0,), "encoder.stem.1.bias": (d0,)})
    for i in range(3):
        c, c2 = s.dims[i], s.dims[i + 1]
        pre = f"encoder.downsample_layers.{i}."
        out.update({pre + "0.weight": (c,), pre + "0.bias": (c,),
                    pre + "1.weight": (c2, c, 2, 2), pre + "1.bias": (c2,)})

    def block(pre, c):
        out.update({pre + "dwconv.weight": (c, 1, 7, 7), pre + "dwconv.bias": (c,),
                    pre + "norm.weight": (c,), pre + "norm.bias": (c,),
                    pre + "pwconv1.weight": (4 * c, c), pre + "pwconv1.bias": (4 * c,),
                    pre + "grn.gamma": (1, 1, 1, 4 * c), pre + "grn.beta": (1, 1, 1, 4 * c),
                    pre + "pwconv2.weight": (c, 4 * c), pre + "pwconv2.bias": (c,)})

    for i, depth in enumerate(s.depths):
        for j in range(depth):
            block(f"encoder.stages.{i}.{j}.", s.dims[i])
    d = s.decoder_dim
    out.update({"proj.weight": (d, s.dims[-1], 1, 1), "proj.bias": (d,),
                "mask_token": (1, d, 1, 1)})
    first = next(iter(s.out_chans))
    for j in range(s.decoder_depth):
        block(f"decoder_dict.{first}.{j}.", d)
    from .model import PIXEL_HEADS

    for name, c in s.out_chans.items():
        if name in PIXEL_HEADS:
            out.update({f"pred_dict.{name}.weight": (s.patch ** 2 * c, d, 1, 1),
                        f"pred_dict.{name}.bias": (s.patch ** 2 * c,)})
        else:
            out.update({f"pred_dict.{name}.weight": (c, d), f"pred_dict.{name}.bias": (c,)})
    out.update({"layer_norm_tmp.weight": (d,), "layer_norm_tmp.bias": (d,),
                "loss_fn.log_vars": (len(s.out_chans),)})
    return out


def inputs(s: Shape, n: int, tile: int, g: torch.Generator) -> dict[str, torch.Tensor]:
    """A batch of the shapes the step takes (values do not change the count)."""
    out = {}
    for name, c in s.out_chans.items():
        if name in ("dynamic_world", "esa_worldcover"):
            out[name] = torch.randint(-1, c, (n, tile, tile, 1), generator=g, dtype=torch.int32)
        elif name in ("biome", "eco_region"):
            out[name] = torch.nn.functional.one_hot(
                torch.randint(0, c, (n,), generator=g), c).to(torch.int32)
        elif name in ("sentinel2", "sentinel1", "aster", "canopy_height_eth"):
            out[name] = torch.randn(n, tile, tile, c, generator=g)
        else:
            out[name] = torch.randn(n, c, generator=g)
    return out


def flops_per_sample(model_cfg: dict) -> float:
    s = Shape(model_cfg)
    g = torch.Generator().manual_seed(0)
    prm = {k: (torch.randn(shape, generator=g) * 0.02).requires_grad_(True)
           for k, shape in param_shapes(s).items()}
    batch = inputs(s, COUNT_BATCH, model_cfg["tile"], g)
    tops = torch.zeros(COUNT_BATCH, dtype=torch.long)
    noise = torch.randn(COUNT_BATCH, s.num_patches, generator=g)
    counter = FlopCounterMode(display=False)
    with counter:
        total, _ = loss(prm, batch, tops, tops, noise, s, F32)
        total.backward()
    return float(counter.get_total_flops()) / COUNT_BATCH


if __name__ == "__main__":
    for path in sys.argv[1:]:
        cfg = json.loads(open(path).read())
        print(path, flops_per_sample(cfg["model"]))

"""ConvNeXtV2 U-Net for GEO-Bench segmentation (port of
``mmearth_tpu/models/unet.py``; upstream models/convnextv2_unet.py:68-275).

NHWC.  The encoder is the dense ConvNeXtV2 trunk (the classifier's stem,
downsamples and :class:`~mmearth_tpu_torch.models.convnextv2.Block`s, whose
depthwise conv's weight gradient is the hand-written kernel of
``ops/dwconv.py``), keeping skip features: the initial conv's output, the
stem's, stage 2's and stage 3's (the original stem keeps its own output in
place of the first two).  The decoder is four :class:`UpsampleBlock`s
(nearest upsample -> 3x3 SAME conv -> LN -> GELU), each but the last
followed by the concatenation of the newest unused skip after the upsampled
map; the last upsamples by the stem stride and takes the initial conv's
output (none with the original stem).  Then ``initial_conv_upsample`` (3x3
conv to dims[0] / 2 -> LN -> GELU) and a 1x1 conv ``head``.

State-dict keys are upstream's ``ConvNeXtV2_unet`` keys: the classifier's
trunk keys, ``upsample_layers.{i}.{conv,norm}.*``,
``initial_conv_upsample.{0,1}.*``, ``head.*``, and upstream's final ``norm``,
registered but unused (the JAX model has no counterpart), so that JAX's
``flax_unet_to_torch(..., dims=dims)`` export strict-loads.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .convnextv2 import Block, conv_nhwc, gelu, init_param
from .norm import LayerNorm


def nearest_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H * scale, W * scale, C), each site repeated."""
    if scale == 1:
        return x
    n, h, w, c = x.shape
    x = x.reshape(n, h, 1, w, 1, c).expand(n, h, scale, w, scale, c)
    return x.reshape(n, h * scale, w * scale, c)


class UpsampleBlock(nn.Module):
    """Nearest upsample by ``scale`` -> 3x3 SAME conv -> LN -> GELU."""

    def __init__(self, in_dim: int, out_dim: int, scale: int = 2, dtype=torch.float32):
        super().__init__()
        self.scale, self.dtype = scale, dtype
        self.conv = nn.Conv2d(in_dim, out_dim, 3, padding=1)
        self.norm = LayerNorm(out_dim, dtype=dtype)

    def forward(self, x):
        return gelu(self.norm(conv_nhwc(nearest_upsample(x, self.scale), self.conv, self.dtype)))


class ConvNeXtV2Unet(nn.Module):
    """The U-Net of ``depths`` and ``dims`` for ``num_classes`` classes; the
    stem stride is ``patch_size / 8`` (s = 1 at patch 8, 2 at patch 16)."""

    def __init__(self, patch_size: int = 16, img_size: int = 112, in_chans: int = 3,
                 num_classes: int = 1000, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 drop_path_rate: float = 0.0, head_init_scale: float = 1.0,
                 use_orig_stem: bool = False, dtype=torch.float32):
        super().__init__()
        self.patch_size, self.img_size = patch_size, img_size
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.head_init_scale, self.use_orig_stem, self.dtype = head_init_scale, use_orig_stem, dtype
        d0, s = dims[0], self.stem_stride
        if use_orig_stem:
            self.stem_orig = nn.Sequential(nn.Conv2d(in_chans, d0, s, stride=s),
                                           LayerNorm(d0, dtype=dtype))
        else:
            self.initial_conv = nn.Sequential(nn.Conv2d(in_chans, d0, 3, padding=1),
                                              LayerNorm(d0, dtype=dtype))
            self.stem = nn.Sequential(nn.Conv2d(d0, d0, s, stride=s, groups=d0),
                                      LayerNorm(d0, dtype=dtype))
        self.downsample_layers = nn.ModuleList(
            nn.Sequential(LayerNorm(dims[i], dtype=dtype),
                          nn.Conv2d(dims[i], dims[i + 1], 2, stride=2))
            for i in range(3))
        rates = iter(float(r) for r in np.linspace(0.0, drop_path_rate, sum(depths)))
        self.stages = nn.ModuleList(
            nn.Sequential(*[Block(dims[i], dtype=dtype, drop_path=next(rates))
                            for _ in range(depths[i])])
            for i in range(4))
        self.norm = LayerNorm(dims[-1], dtype=dtype)  # upstream's, unused
        # upsample_layers[k] (k = 0..3) takes stage 3 - k's width back up,
        # each input the previous output and the skip concatenated after it
        skip = 0 if use_orig_stem else d0
        ins = (dims[3], dims[3] // 2 + dims[2], dims[2] // 2 + dims[1], dims[1] // 2 + d0)
        outs = (dims[3] // 2, dims[2] // 2, dims[1] // 2, d0)
        self.upsample_layers = nn.ModuleList(
            UpsampleBlock(i, o, s if k == 3 else 2, dtype)
            for k, (i, o) in enumerate(zip(ins, outs)))
        self.initial_conv_upsample = nn.Sequential(nn.Conv2d(d0 + skip, d0 // 2, 3, padding=1),
                                                   LayerNorm(d0 // 2, dtype=dtype))
        self.head = nn.Conv2d(d0 // 2, num_classes, 1)

    @property
    def stem_stride(self) -> int:
        return self.patch_size // (2 ** (len(self.depths) - 1))

    def init_weights(self, generator: torch.Generator) -> "ConvNeXtV2Unet":
        """Every conv and Linear weight normal(0.02) and every bias zero, as
        the JAX model's ``init_normal02`` (LN scales and GRN affines keep
        their constructor values); the head's weight times
        ``head_init_scale``."""
        for name, prm in self.named_parameters():
            if name.endswith(".weight") and prm.ndim > 1:
                init_param(prm, "normal02", generator)
            elif name.endswith(".bias"):
                init_param(prm, "zeros", generator)
        with torch.no_grad():
            self.head.weight.mul_(self.head_init_scale)
        return self

    def encoder(self, x, generator: torch.Generator | None = None):
        """The stage-4 map and the skips, oldest first."""
        dt = self.dtype
        if self.use_orig_stem:
            x = self.stem_orig[1](conv_nhwc(x, self.stem_orig[0], dt))
            feats = [x]
        else:
            x = gelu(self.initial_conv[1](conv_nhwc(x, self.initial_conv[0], dt)))
            feats = [x]
            x = self.stem[1](conv_nhwc(x, self.stem[0], dt))
            feats.append(x)
        for i, stage in enumerate(self.stages):
            if i:
                norm, conv = self.downsample_layers[i - 1]
                x = conv_nhwc(norm(x), conv, dt)
            for blk in stage:
                x = blk(x, generator=generator)
            if i in (1, 2):
                feats.append(x)
        return x, feats

    def decoder(self, x, feats):
        for up in self.upsample_layers[:3]:
            x = torch.cat([up(x), feats.pop()], dim=-1)
        x = self.upsample_layers[3](x)
        if not self.use_orig_stem:
            x = torch.cat([x, feats.pop()], dim=-1)
        conv, norm = self.initial_conv_upsample
        return gelu(norm(conv_nhwc(x, conv, self.dtype)))

    def forward(self, x, generator: torch.Generator | None = None):
        """Per-pixel logits (N, H, W, num_classes) of ``x`` (N, H, W,
        in_chans), in the compute dtype; ``generator`` draws the blocks'
        drop-path masks (none without it)."""
        x, feats = self.encoder(x.to(self.dtype), generator)
        return conv_nhwc(self.decoder(x, feats), self.head, self.dtype)


def _factory(depths, dims):
    def build(**kwargs):
        kwargs.setdefault("depths", depths)
        kwargs.setdefault("dims", dims)
        return ConvNeXtV2Unet(**kwargs)

    return build


convnextv2_unet_atto = _factory((2, 2, 6, 2), (40, 80, 160, 320))
convnextv2_unet_femto = _factory((2, 2, 6, 2), (48, 96, 192, 384))
convnextv2_unet_pico = _factory((2, 2, 6, 2), (64, 128, 256, 512))
convnextv2_unet_nano = _factory((2, 2, 8, 2), (80, 160, 320, 640))
convnextv2_unet_tiny = _factory((3, 3, 9, 3), (96, 192, 384, 768))
convnextv2_unet_base = _factory((3, 3, 27, 3), (128, 256, 512, 1024))
convnextv2_unet_large = _factory((3, 3, 27, 3), (192, 384, 768, 1536))
convnextv2_unet_huge = _factory((3, 3, 27, 3), (352, 704, 1408, 2816))

"""ResNet-18/50 baselines and their U-Nets (port of
``mmearth_tpu/models/resnet.py``; upstream builds torchvision's resnet18/50
and ``smp.Unet`` for the comparisons against SeCo, GASSL and Satlas weights,
main_finetune.py:478-501).

NHWC at the interface, NCHW inside.  The modules and their registration
order are torchvision's, so the state dict has its keys in its order
(``conv1``, ``bn1``, ``layer{i}.{j}.conv{c}``/``bn{c}``,
``layer{i}.{j}.downsample.{0,1}``, ``fc``; ``num_batches_tracked`` included)
and a foreign checkpoint loads straight in.  The geometry is the JAX
model's, which departs from torchvision's on purpose (PARITY.md, SAME
padding): every conv and the max pool pad TF-style SAME, so a stride-2
layer on an even input pads less before than after (the 7x7 stem (2, 3),
a 3x3 (0, 1), the 3x3 pool (0, 1) with -inf).

:class:`BatchNorm` is flax's ``BatchNorm(momentum=0.9)``, not torch's: the
statistics are at least f32 whatever the activation dtype, the variance is the biased
one (E[x^2] - E[x]^2, clipped at 0) for the normalisation and for the
running average alike (``ra = 0.9 ra + 0.1 batch``; torch's BatchNorm2d
averages the unbiased variance).  Train mode (``model.train()``) normalises
with the batch's statistics and updates the running ones; eval mode uses
the running ones.  Under a ``process_group`` (``parallel/mesh.py::
set_process_group``) the batch is the global one, as flax computes it under
the sharded jit: the sums of x and x^2 and the count go through one
all-reduce (with its backward), so the statistics, and the running
averages, are the same on every rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import all_reduce_sum
from .convnextv2 import trunc_normal_


def same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF-style SAME padding (before, after) of one axis."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x, conv: nn.Conv2d, dtype):
    """``conv`` on NCHW ``x`` with SAME padding, in ``dtype``."""
    k, s = conv.kernel_size[0], conv.stride[0]
    (t, b), (l, r) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(F.pad(x.to(dtype), (l, r, t, b)), conv.weight.to(dtype), bias, s)


def max_pool_same(x, k: int = 3, s: int = 2):
    (t, b), (l, r) = same_pads(x.shape[2], k, s), same_pads(x.shape[3], k, s)
    return F.max_pool2d(F.pad(x, (l, r, t, b), value=-math.inf), k, s)


class BatchNorm(nn.Module):
    """flax ``BatchNorm(momentum, epsilon=1e-5)`` over NCHW channels, with
    torch's parameter and buffer names."""

    def __init__(self, c: int, momentum: float = 0.9, eps: float = 1e-5, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.process_group = None

    def _batch_stats(self, xf):
        """(mean, biased variance) of the batch, the global one under a
        process group."""
        if self.process_group is None:
            mean = xf.mean((0, 2, 3))
            return mean, (xf.square().mean((0, 2, 3)) - mean.square()).clamp(min=0)
        s1 = xf.sum((0, 2, 3))
        count = torch.full_like(s1[:1], xf.numel() // xf.shape[1])
        sums = all_reduce_sum(torch.cat([s1, xf.square().sum((0, 2, 3)), count]),
                              self.process_group)
        c = s1.shape[0]
        mean = sums[:c] / sums[-1]
        return mean, (sums[c:2 * c] / sums[-1] - mean.square()).clamp(min=0)

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            mean, var = self._batch_stats(xf)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1 - m)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, filters, 3, stride, bias=False)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = nn.Conv2d(filters, filters, 3, bias=False)
        self.bn2 = BatchNorm(filters, dtype=dtype)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, filters, 1, stride, bias=False),
                                         BatchNorm(filters, dtype=dtype))
                           if stride != 1 or cin != filters else None)
        self.dtype = dtype

    def forward(self, x):
        y = F.relu(self.bn1(conv_same(x, self.conv1, self.dtype)))
        y = self.bn2(conv_same(y, self.conv2, self.dtype))
        if self.downsample is not None:
            x = self.downsample[1](conv_same(x, self.downsample[0], self.dtype))
        return F.relu(x + y)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, dtype=torch.float32):
        super().__init__()
        out = filters * 4
        self.conv1 = nn.Conv2d(cin, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters, dtype=dtype)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride, bias=False)
        self.bn2 = BatchNorm(filters, dtype=dtype)
        self.conv3 = nn.Conv2d(filters, out, 1, bias=False)
        self.bn3 = BatchNorm(out, dtype=dtype)
        self.downsample = (nn.Sequential(nn.Conv2d(cin, out, 1, stride, bias=False),
                                         BatchNorm(out, dtype=dtype))
                           if stride != 1 or cin != out else None)
        self.dtype = dtype

    def forward(self, x):
        y = F.relu(self.bn1(conv_same(x, self.conv1, self.dtype)))
        y = F.relu(self.bn2(conv_same(y, self.conv2, self.dtype)))
        y = self.bn3(conv_same(y, self.conv3, self.dtype))
        if self.downsample is not None:
            x = self.downsample[1](conv_same(x, self.downsample[0], self.dtype))
        return F.relu(x + y)


class ResNet(nn.Module):
    """The ResNet of ``stage_sizes`` with ``block``; ``num_classes`` > 0 adds
    the ``fc`` head, 0 leaves the headless encoder of :class:`ResNetUnet`."""

    def __init__(self, stage_sizes, block=BasicBlock, num_classes: int = 1000,
                 in_chans: int = 3, dtype=torch.float32):
        super().__init__()
        self.stage_sizes, self.dtype = tuple(stage_sizes), dtype
        self.bottleneck = block is Bottleneck
        self.conv1 = nn.Conv2d(in_chans, 64, 7, 2, bias=False)
        self.bn1 = BatchNorm(64, dtype=dtype)
        cin, self.widths = 64, [64]
        for i, size in enumerate(stage_sizes):
            blocks = []
            for j in range(size):
                blocks.append(block(cin, 64 * 2 ** i, 2 if i > 0 and j == 0 else 1, dtype))
                cin = 64 * 2 ** i * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
            self.widths.append(cin)
        self.fc = nn.Linear(cin, num_classes) if num_classes > 0 else None

    def layers(self):
        return [getattr(self, f"layer{i + 1}") for i in range(len(self.stage_sizes))]

    def init_weights(self, generator: torch.Generator) -> "ResNet":
        """flax's defaults: conv and fc weights lecun-normal (truncated,
        std sqrt(1 / fan_in)), biases zero, BN scales one, but zero on each
        block's last BN (JAX ``scale_init=zeros``)."""
        init_lecun(self, generator)
        for layer in self.layers():
            for blk in layer:
                with torch.no_grad():
                    (blk.bn3 if isinstance(blk, Bottleneck) else blk.bn2).weight.zero_()
        return self

    def features(self, x):
        """The 6-level pyramid of NCHW ``x``: [x, 1/2, 1/4, 1/8, 1/16, 1/32]
        (smp's encoder output)."""
        x = x.to(self.dtype)
        feats = [x]
        x = F.relu(self.bn1(conv_same(x, self.conv1, self.dtype)))
        feats.append(x)
        x = max_pool_same(x)
        for layer in self.layers():
            x = layer(x)
            feats.append(x)
        return feats

    def forward(self, x, generator: torch.Generator | None = None):
        """Logits of NHWC ``x``, in the compute dtype (``generator`` is
        unused: the ResNets have no drop path)."""
        y = self.features(x.permute(0, 3, 1, 2))[-1].mean((2, 3))
        return F.linear(y, self.fc.weight.to(self.dtype), self.fc.bias.to(self.dtype))


class DecoderBlock(nn.Module):
    """smp's U-Net decoder block: x2 nearest upsample, the skip concatenated
    after it, then twice 3x3 conv (no bias) -> BN -> ReLU."""

    def __init__(self, cin: int, filters: int, dtype=torch.float32):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, filters, 3, bias=False)
        self.norm0 = BatchNorm(filters, dtype=dtype)
        self.conv1 = nn.Conv2d(filters, filters, 3, bias=False)
        self.norm1 = BatchNorm(filters, dtype=dtype)
        self.dtype = dtype

    def forward(self, x, skip=None):
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=1)
        x = F.relu(self.norm0(conv_same(x, self.conv0, self.dtype)))
        return F.relu(self.norm1(conv_same(x, self.conv1, self.dtype)))


class ResNetUnet(nn.Module):
    """``smp.Unet(encoder_name='resnetXX')``: the headless ResNet as
    ``encoder``, decoder blocks at (256, 128, 64, 32, 16) channels, each
    taking the next-finer pyramid level as its skip (the last none: smp
    drops the identity level), and a 3x3 conv ``segmentation_head``.  The
    input's sides must be multiples of 32."""

    def __init__(self, stage_sizes, block=BasicBlock, num_classes: int = 1000,
                 in_chans: int = 3, decoder_channels=(256, 128, 64, 32, 16),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encoder = ResNet(stage_sizes, block, 0, in_chans, dtype)
        skips = self.encoder.widths[-2::-1] + [0]  # 1/16 .. 1/2, then none
        cins = [self.encoder.widths[-1], *decoder_channels[:-1]]
        self.decoder = nn.ModuleList(DecoderBlock(c + s, f, dtype)
                                     for c, s, f in zip(cins, skips, decoder_channels))
        self.segmentation_head = nn.Conv2d(decoder_channels[-1], num_classes, 3)

    def init_weights(self, generator: torch.Generator) -> "ResNetUnet":
        self.encoder.init_weights(generator)
        init_lecun(self.decoder, generator)
        init_lecun(self.segmentation_head, generator)
        return self

    def forward(self, x, generator: torch.Generator | None = None):
        """Per-pixel logits (N, H, W, num_classes) of NHWC ``x`` (``generator``
        unused, as :meth:`ResNet.forward`)."""
        feats = self.encoder.features(x.permute(0, 3, 1, 2))[::-1]
        y, skips = feats[0], [*feats[1:-1], None]
        for blk, skip in zip(self.decoder, skips):
            y = blk(y, skip)
        return conv_same(y, self.segmentation_head, self.dtype).permute(0, 2, 3, 1)


def init_lecun(module: nn.Module, generator: torch.Generator) -> None:
    """Weights of more than one dim lecun-normal over their fan-in, every
    bias zero (BN scales keep their constructor values)."""
    for name, prm in module.named_parameters():
        if prm.ndim > 1:
            trunc_normal_(prm, (1.0 / prm[0].numel()) ** 0.5, generator)
        elif name.endswith("bias"):
            with torch.no_grad():
                prm.zero_()


def resnet_spec(model_name: str) -> tuple[tuple[int, ...], bool]:
    """(stage sizes, bottleneck) for a resnet model name."""
    if "50" in model_name:
        return (3, 4, 6, 3), True
    return (2, 2, 2, 2), False


def build_resnet(model_name: str, **kwargs) -> nn.Module:
    """``resnet18``, ``resnet50``, ``resnet18_unet`` or ``resnet50_unet``."""
    stage_sizes, bottleneck = resnet_spec(model_name)
    cls = ResNetUnet if "unet" in model_name else ResNet
    return cls(stage_sizes, Bottleneck if bottleneck else BasicBlock, **kwargs)

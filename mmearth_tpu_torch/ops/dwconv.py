"""``dwconv7x7``: the dense SAME 7x7 depthwise convolution on NHWC maps, with
a hand-written weight gradient (port of ``mmearth_tpu/ops/dwconv.py``).

The forward and dx are convolutions (``F.conv2d``), as in JAX, where XLA
computes them outside any Pallas kernel (``dwconv.py:97-103,117-124``).  The
weight gradient

    dW[t, c] = sum_{n,h,w} xpad[n, h + t//7, w + t%7, c] * dy[n, h, w, c]

goes to the kernel in ``csrc/dwconv.cu`` on a CUDA tensor and to
:func:`dw_weight_grad_plain` on a CPU tensor; db is an f32 sum.  dW and db
are cast to the param dtype (``dwconv.py:125-126``).  A frozen weight (its
``requires_grad`` off) launches nothing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

KS = 7
# launches of the CUDA kernel (a plain count, read by chip_smoke.py)
LAUNCHES = {"dw_weight_grad": 0}

_SIGNATURES = {"mm_dw7_wgrad": [_build.P] * 3 + [_build.I] * 7 + [_build.P]}
_MAX_CHUNK = 32  # channels a block: one per thread of a tile row
_TILE = 8  # output tile side
_BLOCKS_PER_SM = 4  # blocks to aim for on each SM
_MAX_GRID_Z = 65535


def dw_weight_grad_plain(x, dy):
    """f32 zero-padded x and 49 shifted products summed over (N, H, W), as
    ``dw_weight_grad_reference`` (``dwconv.py:133-142``): (C, 1, 7, 7) f32."""
    n, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, KS // 2, KS // 2, KS // 2, KS // 2))
    dyf = dy.float()
    taps = [(xp[:, a:a + h, b:b + w] * dyf).sum((0, 1, 2)) for a in range(KS) for b in range(KS)]
    return torch.stack(taps, dim=1).reshape(c, 1, KS, KS)


def channel_chunk(c: int) -> int:
    """Channels a block: the largest divisor of C in [16, 32], else
    min(C, 32) with a ragged last chunk."""
    for d in range(_MAX_CHUNK, 15, -1):
        if c % d == 0:
            return d
    return min(c, _MAX_CHUNK)


def samples_per_block(n: int, h: int, w: int, c: int, sms: int) -> int:
    """Samples a block walks: enough blocks to fill ``sms`` SMs
    ``_BLOCKS_PER_SM`` deep, each adding its sums once."""
    tiles = -(-h // _TILE) * -(-w // _TILE)
    per_sample = tiles * -(-c // channel_chunk(c))
    spb = max(1, -(-n * per_sample // (_BLOCKS_PER_SM * sms)))
    return max(spb, -(-n // _MAX_GRID_Z))


def _wgrad_cuda(x, dy):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dw_weight_grad: dtype {x.dtype} not supported (bfloat16, float32)")
    if x.ndim != 4 or dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dw_weight_grad: x and dy must be (N, H, W, C) of one dtype and "
                         f"device, got {tuple(x.shape)} {x.dtype} and {tuple(dy.shape)} {dy.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("dw_weight_grad: x and dy must be contiguous NHWC")
    n, h, w, c = x.shape
    dw = torch.zeros((KS * KS, c), dtype=torch.float32, device=x.device)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    lib = _build.library("dwconv", _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.mm_dw7_wgrad(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), n, h, w, c,
                               channel_chunk(c), samples_per_block(n, h, w, c, sms),
                               int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check(err, "mm_dw7_wgrad")
    LAUNCHES["dw_weight_grad"] += 1
    return dw.t().reshape(c, 1, KS, KS)


def dw_weight_grad(x, dy):
    """dW (C, 1, 7, 7) f32 of a SAME depthwise 7x7 conv of ``x`` (N, H, W, C)
    with output cotangent ``dy``: the plain version on a CPU tensor, the
    kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return dw_weight_grad_plain(x, dy)
    if not x.is_cuda:
        raise RuntimeError(f"dw_weight_grad: no kernel for device {x.device}")
    return _wgrad_cuda(x, dy)


def _conv(x, weight, bias=None):
    """SAME depthwise 7x7 correlation of NHWC ``x`` with (C, 1, 7, 7) taps
    (and bias) cast to x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype), padding=KS // 2,
                 groups=x.shape[-1])
    return y.permute(0, 2, 3, 1)


class _DwConv7x7(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        ctx.bias_dtype = bias.dtype
        return _conv(x, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:  # correlation with the flipped taps
            dx = _conv(dy.to(x.dtype), weight.flip(2, 3))
        if ctx.needs_input_grad[1]:
            dw = dw_weight_grad(x.contiguous(), dy.to(x.dtype).contiguous()).to(weight.dtype)
        if ctx.needs_input_grad[2]:
            db = dy.sum((0, 1, 2), dtype=torch.float32).to(ctx.bias_dtype)
        return dx, dw, db


def dwconv7x7(x, weight, bias):
    """SAME depthwise 7x7 conv of ``x`` (N, H, W, C) in x's dtype, with the
    (C, 1, 7, 7) ``weight`` and (C,) ``bias`` params cast to it (as flax's
    ``nn.Conv(dtype=...)``); its VJP takes dW from :func:`dw_weight_grad`."""
    return _DwConv7x7.apply(x, weight, bias)

"""``dwconv7x7``: the dense SAME 7x7 depthwise convolution on NHWC maps, with
a hand-written weight gradient (port of ``mmearth_tpu/ops/dwconv.py``).

The forward and dx are convolutions (``F.conv2d``), as in JAX, where XLA
computes them outside any Pallas kernel (``dwconv.py:97-103,117-124``).  The
weight gradient

    dW[c, t] = sum_{n,h,w} xpad[n, h + t//7, w + t%7, c] * dy[n, h, w, c]

goes to the kernel in ``csrc/dwconv.cu`` on a CUDA tensor, launched with the
tiling :func:`wgrad_plan` picks from the shape and the card, and to
:func:`dw_weight_grad_plain` on a CPU tensor; db is an f32 sum.  dW and db
are cast to the param dtype (``dwconv.py:125-126``).  A frozen weight (its
``requires_grad`` off) launches nothing.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

KS = 7
# launches of the CUDA kernel (a plain count, read by chip_smoke.py)
LAUNCHES = {"dw_weight_grad": 0}

_SIGNATURES = {"mm_dw7_wgrad": [_build.P] * 4 + [_build.I, _build.P],
               "mm_dw7_smem_optin": []}
_MAX_CHUNK = 64  # channels a block (the kernel's MAX_CHUNK)
_MAX_THREADS = 256  # threads a block (the kernel's MAX_THREADS)
_STRIP = (4, 8)  # output rows and columns a thread sums at a time (the kernel's R, SW)
_BLOCKS_PER_SM = 2  # resident blocks an SM the shared memory must leave room for
_REGS = 128  # registers a thread (the kernel's launch bounds)
_MAX_GRID = 65535  # workers of a chunk (gridDim.x is kept within gridDim.y's limit)
_CARDS: dict[int, tuple[int, int]] = {}  # device index -> (opt-in shared memory, SMs)
_CONFIGS: dict = {}  # (shape, dtype, device) -> the C entry's int arguments


def dw_weight_grad_plain(x, dy):
    """f32 zero-padded x and 49 shifted products summed over (N, H, W), as
    ``dw_weight_grad_reference`` (``dwconv.py:133-142``): (C, 1, 7, 7) f32."""
    n, h, w, c = x.shape
    xp = F.pad(x.float(), (0, 0, KS // 2, KS // 2, KS // 2, KS // 2))
    dyf = dy.float()
    taps = [(xp[:, a:a + h, b:b + w] * dyf).sum((0, 1, 2)) for a in range(KS) for b in range(KS)]
    return torch.stack(taps, dim=1).reshape(c, 1, KS, KS)


class WgradPlan(NamedTuple):
    """One launch's shape: tiles of ``th x tw`` output sites, ``cc``
    channels a block, ``workers`` blocks for each chunk walking the (sample,
    tile) units, ``threads`` threads on ``smem`` bytes of shared memory, and
    16-byte staging if ``vec``."""
    th: int
    tw: int
    cc: int
    workers: int
    threads: int
    smem: int
    vec: bool


def channel_chunk(c: int, elem_bytes: int) -> tuple[int, bool]:
    """(channels a block, 16-byte staging): 32 where it divides C (a warp
    then reads one site's channels, no bank conflicts), else the largest
    divisor of C up to 64 that a 16-byte copy can stage, else (C not a
    multiple of 16 bytes) the largest divisor up to 64, staged with scalar
    loads."""
    per = 16 // elem_bytes
    if c % per == 0:
        if c % 32 == 0:
            return 32, True
        return max(d for d in range(per, _MAX_CHUNK + 1, per) if c % d == 0), True
    return max(d for d in range(1, min(c, _MAX_CHUNK) + 1) if c % d == 0), False


def smem_bytes(th: int, tw: int, cc: int, elem_bytes: int) -> int:
    """Two buffers, each one sample's (th+6) x (tw+6) x halo and th x tw dy
    tile in the activation dtype (the first later holds the (cc, 49) f32
    sums)."""
    sites = (th + KS - 1) * (tw + KS - 1) + th * tw
    return max(2 * sites * cc * elem_bytes, KS * KS * cc * 4)


@functools.lru_cache(maxsize=None)
def wgrad_plan(n: int, h: int, w: int, c: int, elem_bytes: int, smem_optin: int,
               sms: int) -> WgradPlan:
    """The launch shape of the weight gradient of (N, H, W, C) maps on a card
    whose blocks may opt in to ``smem_optin`` bytes and that has ``sms`` SMs.

    The tile (rows a multiple of 4, columns of 8, no larger than the map
    rounded up) is the one whose halos stage the fewest sites over the image,
    among those that leave room for two blocks an SM, give the launch at
    least two blocks an SM with one sample a block (else as many blocks as
    any does) and give every thread as many strips (else any).  The threads
    are the chunk's channels times one slot per strip of 4 x 8 sites, at most
    256.  The workers are one wave: as many blocks as the card holds at once
    (by shared memory, threads and 128 registers a thread), shared among the
    chunks, each walking the (sample, tile) units from its own."""
    cc, vec = channel_chunk(c, elem_bytes)
    limit = smem_optin // _BLOCKS_PER_SM - 1024
    rs, sw = _STRIP
    best = None
    for th in range(rs, -(-h // rs) * rs + 1, rs):
        for tw in range(sw, -(-w // sw) * sw + 1, sw):
            smem = smem_bytes(th, tw, cc, elem_bytes)
            if smem > limit:
                continue
            tiles = -(-h // th) * -(-w // tw)
            blocks = n * tiles * (c // cc)
            staged = tiles * (th + KS - 1) * (tw + KS - 1)
            strips = (th // rs) * (tw // sw)
            uneven = strips % min(strips, max(1, _MAX_THREADS // cc)) != 0
            key = (blocks < _BLOCKS_PER_SM * sms, uneven, staged, -blocks)
            if best is None or key < best[0]:
                best = (key, th, tw, smem, tiles)
    if best is None:
        raise ValueError(f"dw_weight_grad: no tile of C = {c} fits {smem_optin} bytes")
    _, th, tw, smem, tiles = best
    strips = (th // rs) * (tw // sw)
    threads = cc * min(strips, max(1, _MAX_THREADS // cc))
    warps = -(-threads // 32)
    # an SM's shared memory is the opt-in bytes and 1 KB, 1 KB of it taken a block
    resident = min((smem_optin + 1024) // (smem + 1024), 65536 // (_REGS * 32 * warps),
                   64 // warps, 32)
    workers = min(n * tiles, _MAX_GRID, max(1, resident * sms // (c // cc)))
    return WgradPlan(th, tw, cc, workers, threads, smem, vec)


def _lib():
    return _build.library("dwconv", _SIGNATURES)


def _card(device) -> tuple[int, int]:
    """(opt-in shared memory per block, SMs) of the card, once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _CARDS:
        with torch.cuda.device(idx):
            optin = _lib().mm_dw7_smem_optin()
        _CARDS[idx] = (optin, torch.cuda.get_device_properties(idx).multi_processor_count)
    return _CARDS[idx]


def launch_plan(x) -> WgradPlan:
    """The plan for x's shape and dtype on its card."""
    return wgrad_plan(*x.shape, x.element_size(), *_card(x.device))


def _config(x) -> int:
    """Address of the C entry's int arguments for x's shape on its card (N, H,
    W, C, the plan's cc, th, tw, workers, threads, smem and vec, is_bf16), made
    once per shape: one pointer crosses ctypes in place of twelve ints."""
    key = (x.shape, x.dtype, x.get_device())
    cfg = _CONFIGS.get(key)
    if cfg is None:
        plan = launch_plan(x)
        cfg = (ctypes.c_int * 12)(*x.shape, plan.cc, plan.th, plan.tw, plan.workers,
                                  plan.threads, plan.smem, int(plan.vec),
                                  int(x.dtype == torch.bfloat16))
        _CONFIGS[key] = cfg
    return ctypes.addressof(cfg)


def _wgrad_cuda(x, dy):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"dw_weight_grad: dtype {x.dtype} not supported (bfloat16, float32)")
    if x.ndim != 4 or dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dw_weight_grad: x and dy must be (N, H, W, C) of one dtype and "
                         f"device, got {tuple(x.shape)} {x.dtype} and {tuple(dy.shape)} {dy.dtype}")
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("dw_weight_grad: x and dy must be contiguous NHWC")
    dw = torch.empty((x.shape[-1], 1, KS, KS), dtype=torch.float32, device=x.device)
    err = _lib().mm_dw7_wgrad(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), _config(x),
                              x.get_device(), _build.stream_ptr(x.device))
    _build.check(err, "mm_dw7_wgrad")
    LAUNCHES["dw_weight_grad"] += 1
    return dw


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

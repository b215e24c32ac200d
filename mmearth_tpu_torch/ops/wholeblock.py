"""``dwconv7_gathered``: scatter -> depthwise 7x7 SAME conv -> gather, fused.

Port of ``mmearth_tpu/ops/wholeblock.py``.  The spatial op of every gathered
encoder block: the visible patches ``x_g (N, K, p, p, C)`` are placed on the
implied dense ``(N, h, h, C)`` grid (zeros at removed patches), convolved
depthwise with 7x7 taps plus a bias, and read back at the visible sites.
The taps are rounded to the activation dtype, the accumulator and the bias
are f32 and the output is stored in the activation dtype, as in the TPU
kernel (``wholeblock.py:220-221``).  The VJP gives ``dx`` (the flipped-tap
correlation of the scattered cotangent, gathered), ``dK`` (taps summed over
the batch, f32) and ``db`` (f32).

On a CUDA tensor both directions go to the kernels in ``csrc/wholeblock.cu``
at every patch side p = 8/4/2/1 (the TPU kernel ran only at p = 8); on a CPU
tensor to the plain versions below: scatter -> ``F.conv2d(groups=C,
padding=3)`` -> gather, in f32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .patch_select import gather_patches_plain, scatter_patches_plain

KS = 7
# launches of each CUDA kernel (a plain count, read by chip_smoke.py)
LAUNCHES = {"dwconv7_gathered_fwd": 0, "dwconv7_gathered_bwd": 0}

_SIGNATURES = {
    "mm_dwconv7_fwd": [_build.P] * 6 + [_build.I] * 7 + [_build.P],
    "mm_dwconv7_bwd": [_build.P] * 8 + [_build.I] * 8 + [_build.P],
}
_SMEM_FWD = 48 * 1024  # bytes of the forward block's halo + taps
_MAX_CHUNK = 80  # the backward keeps 49 * chunk dK partials in 256 x 16 registers
_BWD_BLOCKS = 1056  # backward blocks to aim for (8 per SM on 132 SMs)


# ---------------------------------------------------------------------------
# plain versions (f32 scatter -> conv2d -> gather)
# ---------------------------------------------------------------------------
def _taps(weight, dtype):
    """(C, 1, 7, 7) param -> f32 taps holding the activation-dtype rounding."""
    return weight.to(dtype).float()


def _dense_nchw(x_g, kept_ids, grid):
    p = x_g.shape[2]
    return scatter_patches_plain(x_g.float(), kept_ids, p, grid, grid * p).permute(0, 3, 1, 2)


def _gather_nchw(y, kept_ids, p, grid, dtype):
    return gather_patches_plain(y.permute(0, 2, 3, 1), kept_ids, p, grid).to(dtype)


def dwconv7_gathered_plain(x_g, kept_ids, weight, bias, grid: int):
    p, c = x_g.shape[2], x_g.shape[-1]
    y = F.conv2d(_dense_nchw(x_g, kept_ids, grid), _taps(weight, x_g.dtype), bias.float(),
                 padding=KS // 2, groups=c)
    return _gather_nchw(y, kept_ids, p, grid, x_g.dtype)


def dwconv7_gathered_bwd_plain(dt, x_g, kept_ids, weight, grid: int):
    """(dx, dK (C, 1, 7, 7) f32, db (C,) f32)."""
    p, c = x_g.shape[2], x_g.shape[-1]
    h = grid * p
    dtd = _dense_nchw(dt, kept_ids, grid)
    dxd = F.conv2d(dtd, _taps(weight, x_g.dtype).flip(2, 3), padding=KS // 2, groups=c)
    xpad = F.pad(_dense_nchw(x_g, kept_ids, grid), (3, 3, 3, 3))
    dk = torch.stack([(xpad[:, :, a:a + h, b:b + h] * dtd).sum((0, 2, 3))
                      for a in range(KS) for b in range(KS)], dim=1)
    return (_gather_nchw(dxd, kept_ids, p, grid, x_g.dtype), dk.reshape(c, 1, KS, KS),
            dtd.sum((0, 2, 3)))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def channel_chunk(p: int, c: int) -> int:
    """Channels per block: the largest divisor of C that keeps the forward's
    (p+6)^2 halo plus the 49 taps (f32) within 48 KB and the backward's dK
    partials within its registers."""
    per_ch = ((p + 6) ** 2 + KS * KS) * 4
    limit = min(_MAX_CHUNK, _SMEM_FWD // per_ch)
    return max(d for d in range(1, limit + 1) if c % d == 0)


def _check(x_g, kept_ids, inv_ids, grid: int, name: str):
    if x_g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {x_g.dtype} not supported (bfloat16, float32)")
    n, k, p, p2, _ = x_g.shape
    if p != p2 or not x_g.is_contiguous():
        raise ValueError(f"{name}: x_g must be contiguous (N, K, p, p, C), got {tuple(x_g.shape)}")
    for ids, shape in ((kept_ids, (n, k)), (inv_ids, (n, grid * grid))):
        if (ids.dtype != torch.int32 or tuple(ids.shape) != shape or not ids.is_contiguous()
                or ids.device != x_g.device):
            raise ValueError(f"{name}: ids must be contiguous int32 {shape} on {x_g.device}")


def _taps49(weight, dtype):
    c = weight.shape[0]
    return _taps(weight, dtype).reshape(c, KS * KS).t().contiguous()


def _fwd_cuda(x_g, kept_ids, inv_ids, weight, bias, grid: int):
    _check(x_g, kept_ids, inv_ids, grid, "dwconv7_gathered")
    n, k, p, _, c = x_g.shape
    taps = _taps49(weight, x_g.dtype)
    bias32 = bias.float().contiguous()
    out = torch.empty_like(x_g)
    lib = _build.library("wholeblock", _SIGNATURES)
    with torch.cuda.device(x_g.device):
        err = lib.mm_dwconv7_fwd(x_g.data_ptr(), kept_ids.data_ptr(), inv_ids.data_ptr(),
                                 taps.data_ptr(), bias32.data_ptr(), out.data_ptr(), n, k, p,
                                 grid, c, channel_chunk(p, c), int(x_g.dtype == torch.bfloat16),
                                 _build.stream_ptr(x_g.device))
    _build.check(err, "mm_dwconv7_fwd")
    LAUNCHES["dwconv7_gathered_fwd"] += 1
    return out


def _bwd_cuda(dt, x_g, kept_ids, inv_ids, weight, grid: int):
    _check(x_g, kept_ids, inv_ids, grid, "dwconv7_gathered backward")
    if dt.shape != x_g.shape or dt.dtype != x_g.dtype or not dt.is_contiguous():
        raise ValueError("dwconv7_gathered backward: dt must match x_g")
    n, k, p, _, c = x_g.shape
    cc = channel_chunk(p, c)
    rows_per_block = max(1, -(-n * k * (c // cc) // _BWD_BLOCKS))
    taps = _taps49(weight, x_g.dtype)
    dx = torch.empty_like(x_g)
    dk = torch.zeros((KS * KS, c), dtype=torch.float32, device=x_g.device)
    db = torch.zeros((c,), dtype=torch.float32, device=x_g.device)
    lib = _build.library("wholeblock", _SIGNATURES)
    with torch.cuda.device(x_g.device):
        err = lib.mm_dwconv7_bwd(dt.data_ptr(), x_g.data_ptr(), kept_ids.data_ptr(),
                                 inv_ids.data_ptr(), taps.data_ptr(), dx.data_ptr(),
                                 dk.data_ptr(), db.data_ptr(), n, k, p, grid, c, cc,
                                 rows_per_block, int(x_g.dtype == torch.bfloat16),
                                 _build.stream_ptr(x_g.device))
    _build.check(err, "mm_dwconv7_bwd")
    LAUNCHES["dwconv7_gathered_bwd"] += 1
    return dx, dk.t().reshape(c, 1, KS, KS), db


def _device_kind(t, name):
    if t.device.type == "cpu":
        return "cpu"
    if not t.is_cuda:
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return "cuda"


def dwconv7_gathered_fwd(x_g, kept_ids, inv_ids, weight, bias, grid: int):
    if _device_kind(x_g, "dwconv7_gathered") == "cpu":
        return dwconv7_gathered_plain(x_g, kept_ids, weight, bias, grid)
    return _fwd_cuda(x_g, kept_ids, inv_ids, weight, bias, grid)


def dwconv7_gathered_bwd(dt, x_g, kept_ids, inv_ids, weight, grid: int):
    if _device_kind(x_g, "dwconv7_gathered backward") == "cpu":
        return dwconv7_gathered_bwd_plain(dt, x_g, kept_ids, weight, grid)
    return _bwd_cuda(dt, x_g, kept_ids, inv_ids, weight, grid)


class _DwConv7Gathered(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_g, weight, bias, kept_ids, inv_ids, grid):
        ctx.save_for_backward(x_g, weight, kept_ids, inv_ids)
        ctx.grid = grid
        return dwconv7_gathered_fwd(x_g, kept_ids, inv_ids, weight, bias, grid)

    @staticmethod
    def backward(ctx, dt):
        x_g, weight, kept_ids, inv_ids = ctx.saved_tensors
        dx, dk, db = dwconv7_gathered_bwd(dt.contiguous(), x_g, kept_ids, inv_ids, weight,
                                          ctx.grid)
        return dx, dk.to(weight.dtype), db.to(weight.dtype), None, None, None


def dwconv7_gathered(x_g, kept_ids, inv_ids, weight, bias, grid: int):
    """``gather(dwconv7x7_SAME(scatter(x_g)) + bias)`` with its full VJP.

    x_g: (N, K, p, p, C) visible rows; kept_ids (N, K) / inv_ids (N, L) int32
    from :func:`mmearth_tpu_torch.models.convnextv2.visible_ids`; weight
    (C, 1, 7, 7) and bias (C,) f32 params (torch depthwise layout)."""
    return _DwConv7Gathered.apply(x_g, weight, bias, kept_ids, inv_ids, grid)

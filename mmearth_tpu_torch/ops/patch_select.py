"""Patch gather / scatter between a dense NHWC grid and gathered visible rows.

Port of ``mmearth_tpu/ops/patch_select.py``.  The gathered sparse encoder moves
the stem output from the dense ``(N, H, W, C)`` grid onto the ``(N, K, p, p, C)``
rows of the K visible patches, and moves stage 4 back to the dense grid with
zeros at removed patches.  Each op is the other's VJP; both are bit-exact.

On a CUDA tensor the work goes to the hand-written kernels in
``csrc/patch_select.cu``; on a CPU tensor to the plain index-op versions
below, which are also what the kernels are held against.
"""
from __future__ import annotations

import torch

from . import _build

# launches of each CUDA kernel (a plain count, read by chip_smoke.py)
LAUNCHES = {"gather_patches": 0, "scatter_patches": 0}

_SIGNATURES = {
    "mm_gather_patches": [_build.P] * 3 + [_build.I] * 9 + [_build.P],
    "mm_scatter_patches": [_build.P] * 3 + [_build.I] * 9 + [_build.P],
}


def to_patches(x: torch.Tensor, grid: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, grid*grid, p, p, C), patch-major (row-major patches)."""
    n, h, w, c = x.shape
    p = h // grid
    x = x.reshape(n, grid, p, grid, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, grid * grid, p, p, c)


def from_patches(xp: torch.Tensor, grid: int) -> torch.Tensor:
    """Inverse of :func:`to_patches`."""
    n, _, p, _, c = xp.shape
    x = xp.reshape(n, grid, grid, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, grid * p, grid * p, c)


# ---------------------------------------------------------------------------
# plain versions (index ops)
# ---------------------------------------------------------------------------
def gather_patches_plain(x, kept_ids, p: int, grid: int):
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return to_patches(x, grid)[rows, kept_ids.long()]


def scatter_patches_plain(xg, kept_ids, p: int, grid: int, h: int):
    n, _, _, _, c = xg.shape
    dense = xg.new_zeros((n, grid * grid, p, p, c))
    rows = torch.arange(n, device=xg.device)[:, None]
    dense[rows, kept_ids.long()] = xg
    return from_patches(dense, grid)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _vec_bytes(row_bytes: int, *tensors) -> int:
    for v in (16, 8, 4, 2):
        if row_bytes % v == 0 and all(t.data_ptr() % v == 0 for t in tensors):
            return v
    raise ValueError(f"patch row of {row_bytes} bytes is not 2-byte aligned")


def _check(t: torch.Tensor, ids: torch.Tensor, name: str) -> None:
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {t.dtype} not supported (bfloat16, float32)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if ids.dtype != torch.int32 or not ids.is_contiguous() or ids.device != t.device:
        raise ValueError(f"{name}: ids must be contiguous int32 on {t.device}")


def _launch(fn: str, src, ids, out, n, h, c, k, p, grid) -> None:
    lib = _build.library("patch_select", _SIGNATURES)
    vec = _vec_bytes(c * src.element_size(), src, out)
    with torch.cuda.device(src.device):
        err = getattr(lib, fn)(src.data_ptr(), ids.data_ptr(), out.data_ptr(), n, h, h, c,
                               k, p, grid, src.element_size(), vec,
                               _build.stream_ptr(src.device))
    _build.check(err, fn)


def _gather(x, kept_ids, p: int, grid: int):
    if x.device.type == "cpu":
        return gather_patches_plain(x, kept_ids, p, grid)
    if not x.is_cuda:
        raise RuntimeError(f"gather_patches: no kernel for device {x.device}")
    n, h, w, c = x.shape
    k = kept_ids.shape[1]
    _check(x, kept_ids, "gather_patches")
    if h != grid * p or w != h or kept_ids.shape[0] != n:
        raise ValueError(f"gather_patches: shape {tuple(x.shape)} vs p={p} grid={grid}")
    out = torch.empty((n, k, p, p, c), dtype=x.dtype, device=x.device)
    _launch("mm_gather_patches", x, kept_ids, out, n, h, c, k, p, grid)
    LAUNCHES["gather_patches"] += 1
    return out


def _scatter(xg, kept_ids, inv_ids, p: int, grid: int, h: int):
    if xg.device.type == "cpu":
        return scatter_patches_plain(xg, kept_ids, p, grid, h)
    if not xg.is_cuda:
        raise RuntimeError(f"scatter_patches: no kernel for device {xg.device}")
    n, k, _, _, c = xg.shape
    _check(xg, inv_ids, "scatter_patches")
    if h != grid * p or xg.shape[2:4] != (p, p) or inv_ids.shape != (n, grid * grid):
        raise ValueError(f"scatter_patches: shape {tuple(xg.shape)} vs p={p} grid={grid}")
    out = torch.empty((n, h, h, c), dtype=xg.dtype, device=xg.device)
    _launch("mm_scatter_patches", xg, inv_ids, out, n, h, c, k, p, grid)
    LAUNCHES["scatter_patches"] += 1
    return out


# ---------------------------------------------------------------------------
# public ops (each one's backward is the other)
# ---------------------------------------------------------------------------
class _GatherPatches(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kept_ids, inv_ids, p, grid):
        ctx.save_for_backward(kept_ids, inv_ids)
        ctx.geom = (p, grid, x.shape[1])
        return _gather(x, kept_ids, p, grid)

    @staticmethod
    def backward(ctx, dy):
        kept_ids, inv_ids = ctx.saved_tensors
        p, grid, h = ctx.geom
        return _scatter(dy.contiguous(), kept_ids, inv_ids, p, grid, h), None, None, None, None


class _ScatterPatches(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, kept_ids, inv_ids, p, grid, h):
        ctx.save_for_backward(kept_ids)
        ctx.geom = (p, grid)
        return _scatter(xg, kept_ids, inv_ids, p, grid, h)

    @staticmethod
    def backward(ctx, dy):
        (kept_ids,) = ctx.saved_tensors
        p, grid = ctx.geom
        return _gather(dy.contiguous(), kept_ids, p, grid), None, None, None, None, None


def gather_patches(x, kept_ids, inv_ids, p: int, grid: int):
    """Dense (N, H, W, C) -> (N, K, p, p, C) rows of the ``kept_ids`` patches."""
    return _GatherPatches.apply(x, kept_ids, inv_ids, p, grid)


def scatter_patches(xg, kept_ids, inv_ids, p: int, grid: int, h: int):
    """(N, K, p, p, C) rows -> dense (N, h, h, C), zeros at removed patches."""
    return _ScatterPatches.apply(xg, kept_ids, inv_ids, p, grid, h)

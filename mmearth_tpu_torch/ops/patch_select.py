"""Patch gather / scatter between a dense NHWC grid and gathered visible rows.

Port of ``mmearth_tpu/ops/patch_select.py``.  The gathered sparse encoder moves
the stem output from the dense ``(N, H, W, C)`` grid onto the ``(N, K, p, p, C)``
rows of the K visible patches, and moves stage 4 back to the dense grid with
zeros at removed patches.  Each op is the other's VJP; both are bit-exact.

On a CUDA tensor the work goes to the hand-written kernels in
``csrc/patch_select.cu``: persistent copies over the rows of the output, on
Hopper's bulk copies where the rows and pointers allow it, else through
registers, as :func:`copy_plan` decides; on a CPU tensor to the plain
index-op versions below, which are also what the kernels are held against.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

# launches of each CUDA kernel (a plain count, read by chip_smoke.py)
LAUNCHES = {"gather_patches": 0, "scatter_patches": 0}

_SIGNATURES = {
    "mm_gather_patches": [_build.P] * 4 + [_build.I, _build.P],
    "mm_scatter_patches": [_build.P] * 4 + [_build.I, _build.P],
    "mm_patch_occupancy": [_build.I] * 4,
    "mm_patch_smem_optin": [],
}
_ENTRIES: dict = {}  # C entry name -> its ctypes function
_CARDS: dict[int, tuple[int, int]] = {}  # device index -> (opt-in shared memory, SMs)
_OCCUPANCY: dict = {}  # (device, scatter, bulk, vec, smem) -> blocks an SM
_CONFIGS: dict = {}  # launch key -> the C entry's Config ints


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
SLOT_BYTES = 8192  # a bulk slot: twelve 640-byte atto rows, four 2 KB pico rows
SLOTS = 4  # bulk ring slots: the loads of two groups run ahead of the one stored
MAX_GROUP = 32  # units a bulk group: one a lane of the block's warp
REG_GROUP = 4  # rows a warp's group on the register path (the kernel's kRegUnits)
REG_WARPS = 8  # warps a register-path block (the kernel's kRegThreads / 32)


class CopyPlan(NamedTuple):
    """One launch: the path (``bulk``: Hopper's bulk copies through a ring of
    ``slots`` shared-memory slots of ``slot_bytes``, one warp a block; else
    the register path with ``vec``-byte accesses, ``REG_WARPS`` warps a
    block), the unit (a chunk of ``chunk_bytes`` of a ``row_bytes`` row,
    ``chunks`` a row, the last one shorter where they do not divide it),
    ``group`` units a group, and the persistent grid: ``blocks`` blocks on
    ``smem`` bytes of dynamic shared memory, block b walking groups b,
    b + blocks, ... of ``groups`` (on the register path each warp in turn).
    Its fields after ``row_bytes`` are the C entry's ``Config`` in order."""
    row_bytes: int
    bulk: bool
    vec: int
    chunk_bytes: int
    chunks: int
    group: int
    slots: int
    slot_bytes: int
    units: int
    groups: int
    blocks: int
    smem: int


def bulk_smem(slots: int, slot_bytes: int, scatter: bool) -> int:
    """Shared memory of a bulk block, as the kernel lays it out: the ring,
    scatter's zero slot, an 8-byte barrier and a 4-byte mask a slot."""
    return (slots + int(scatter)) * slot_bytes + slots * 12


def pointer_align(*ptrs: int) -> int:
    """The largest of 16/8/4/2/1 bytes that divides every address."""
    bits = 16
    for ptr in ptrs:
        bits |= ptr
    return min(16, bits & -bits)


def copy_plan(rows: int, row_bytes: int, align: int, scatter: bool, sms: int, occupancy,
              smem_optin: int) -> CopyPlan:
    """The launch of one direction over ``rows`` output rows of
    ``row_bytes`` (gather: N*K*p; scatter: the dense N*L*p), with base
    pointers aligned to ``align`` bytes, on a card of ``sms`` SMs whose
    blocks may opt in to ``smem_optin`` bytes of shared memory;
    ``occupancy(scatter, bulk, vec, smem)`` gives the blocks an SM holds of
    the kernel that runs.

    The rule: the bulk path wherever a bulk copy may move the rows, that is
    where the row is a multiple of 16 bytes and both pointers are 16-byte
    aligned; the register path elsewhere, with the widest vector (8, 4 or 2
    bytes) that divides the row and both pointers.  A bulk unit is a whole
    row where it fits a slot (as many rows a group as fit, at most one a
    lane), else a 16-byte multiple chunk of it, one a group; the slot
    shrinks to fit the card.  The grid is the SMs times the blocks an SM
    holds, at most one group a block (a warp) in all; the blocks take the
    groups in turn, so that the card writes a window of the output that
    moves through it in order (on an H100 the stem scatters ran about 15%
    faster so than with a contiguous range a block)."""
    bulk = row_bytes % 16 == 0 and align % 16 == 0
    if bulk:
        vec, slots, slot = 16, SLOTS, SLOT_BYTES
        while bulk_smem(slots, slot, scatter) > smem_optin and slot > 128:
            slot //= 2
        chunks = -(-row_bytes // slot)
        chunk = -(-row_bytes // chunks // 16) * 16
        group = min(MAX_GROUP, slot // row_bytes) if chunks == 1 else 1
        smem, warps = bulk_smem(slots, slot, scatter), 1
    else:
        vec = next(v for v in (8, 4, 2, 1) if row_bytes % v == 0 and align % v == 0)
        if vec == 1:
            raise ValueError(f"patch copy: a {row_bytes}-byte row is not 2-byte aligned")
        slots = slot = smem = 0
        chunks, chunk, group, warps = 1, row_bytes, REG_GROUP, REG_WARPS
    units = rows * chunks
    groups = -(-units // group)
    if groups == 0:
        return CopyPlan(row_bytes, bulk, vec, chunk, chunks, group, slots, slot, units, 0, 0, smem)
    resident = max(1, occupancy(scatter, bulk, vec, smem))
    blocks = min(sms * resident, -(-groups // warps))
    return CopyPlan(row_bytes, bulk, vec, chunk, chunks, group, slots, slot, units, groups,
                    blocks, smem)


def _card(device) -> tuple[int, int]:
    """(opt-in shared memory per block, SMs) of the card, once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _CARDS:
        with torch.cuda.device(idx):
            optin = _entry("mm_patch_smem_optin")()
        _CARDS[idx] = (optin, torch.cuda.get_device_properties(idx).multi_processor_count)
    return _CARDS[idx]


def _occupancy(idx: int):
    """The occupancy API of device ``idx`` as ``copy_plan`` takes it."""
    def blocks(scatter, bulk, vec, smem):
        key = (idx, scatter, bulk, vec, smem)
        if key not in _OCCUPANCY:
            with torch.cuda.device(idx):
                n = _entry("mm_patch_occupancy")(int(scatter), int(bulk), vec, smem)
            _build.check(-n if n < 0 else 0, "mm_patch_occupancy")
            _OCCUPANCY[key] = n
        return _OCCUPANCY[key]
    return blocks


def launch_plan(src, ids, p: int, grid: int, scatter: bool, out_align: int = 16) -> CopyPlan:
    """The plan of one launch on ``src``'s card: gather of the dense ``src``
    at the ``ids`` (N, K) kept patches, or scatter of the gathered ``src``
    onto the dense grid through ``ids`` (N, grid^2); ``out_align``: the
    output's alignment (a fresh tensor's is at least 16 bytes)."""
    n, c = src.shape[0], src.shape[-1]
    rows = n * (grid * grid if scatter else ids.shape[1]) * p
    optin, sms = _card(src.device)
    return copy_plan(rows, p * c * src.element_size(), pointer_align(src.data_ptr(), out_align),
                     scatter, sms, _occupancy(src.get_device()), optin)


def _config(src, ids, p: int, grid: int, scatter: bool, align: int, device: int) -> int:
    """Address of the C entry's ``Config`` for this launch, made once per
    (direction, shape, dtype, ids shape, alignment, device): N, K, p, grid
    and the plan's fields."""
    key = (scatter, src.shape, src.dtype, ids.shape, p, grid, align, device)
    cfg = _CONFIGS.get(key)
    if cfg is None:
        plan = launch_plan(src, ids, p, grid, scatter, align)
        k = src.shape[1] if scatter else ids.shape[1]
        cfg = (ctypes.c_int * 16)(src.shape[0], k, p, grid, *(int(v) for v in plan))
        _CONFIGS[key] = cfg
    return ctypes.addressof(cfg)


def _entry(name: str):
    """The C entry ``name``, looked up once."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = _ENTRIES[name] = getattr(_build.library("patch_select", _SIGNATURES), name)
    return fn


def _check(t: torch.Tensor, ids: torch.Tensor, name: str) -> None:
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {t.dtype} not supported (bfloat16, float32)")
    if not t.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    if ids.dtype != torch.int32 or not ids.is_contiguous() or ids.device != t.device:
        raise ValueError(f"{name}: ids must be contiguous int32 on {t.device}")


def _launch(fn: str, src, ids, out, p: int, grid: int, scatter: bool) -> None:
    """One launch on the current stream of ``src``'s device, which the C
    entry makes current only where it is not."""
    sp, op, dev = src.data_ptr(), out.data_ptr(), src.get_device()
    cfg = _config(src, ids, p, grid, scatter, pointer_align(sp, op), dev)
    err = _entry(fn)(sp, ids.data_ptr(), op, cfg, dev, _build.stream_ptr(src.device))
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
    _launch("mm_gather_patches", x, kept_ids, out, p, grid, False)
    LAUNCHES["gather_patches"] += 1
    return out


def _scatter(xg, kept_ids, inv_ids, p: int, grid: int, h: int):
    if xg.device.type == "cpu":
        return scatter_patches_plain(xg, kept_ids, p, grid, h)
    if not xg.is_cuda:
        raise RuntimeError(f"scatter_patches: no kernel for device {xg.device}")
    n, _, _, _, c = xg.shape
    _check(xg, inv_ids, "scatter_patches")
    if h != grid * p or xg.shape[2:4] != (p, p) or inv_ids.shape != (n, grid * grid):
        raise ValueError(f"scatter_patches: shape {tuple(xg.shape)} vs p={p} grid={grid}")
    out = torch.empty((n, h, h, c), dtype=xg.dtype, device=xg.device)
    _launch("mm_scatter_patches", xg, inv_ids, out, p, grid, True)
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

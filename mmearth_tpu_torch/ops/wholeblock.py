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
at every patch side p = 16/8/4/2/1 (the TPU kernel ran at p >= 8), one
launch each; on a CPU tensor to the plain versions below: scatter ->
``F.conv2d(groups=C, padding=3)`` -> gather, in f32.  A kernel block owns a
tile of patches of one image and a chunk of channels; :func:`tile_plan`
picks the tile, the chunk, the threads and the shared memory from the shape
and the card, and the wrapper hands them to the C entry.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .patch_select import gather_patches_plain, scatter_patches_plain

KS = 7
# launches of each CUDA kernel (a plain count, read by chip_smoke.py)
LAUNCHES = {"dwconv7_gathered_fwd": 0, "dwconv7_gathered_bwd": 0}

_SIGNATURES = {
    "mm_dwconv7_fwd": [_build.P] * 6 + [_build.I, _build.P],
    "mm_dwconv7_bwd": [_build.P] * 7 + [_build.I, _build.P],
    "mm_dwconv7_smem_optin": [],
}
_MAX_CHUNK = 64  # channels a block (the kernel's MAX_CHUNK)
_MAX_THREADS = 256  # threads a block (the kernel's MAX_THREADS)
_RED_PITCH = KS * KS + 2  # f32 words of one channel's dK and db sums in shared memory
# rows of a patch one work item computes, by patch side (the kernel's Side<P>::R)
_ROWS = {1: 1, 2: 2, 4: 4, 8: 2, 16: 1}
_BLOCKS_PER_SM = 3  # blocks a launch should give each SM
_CARDS: dict[int, tuple[int, int]] = {}  # device index -> (opt-in shared memory, SMs)
_CONFIGS: dict = {}  # (shape, dtype, grid, bwd, device) -> the C entry's int arguments


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
class TilePlan(NamedTuple):
    """One launch's shape: a block owns ``tpy x tpx`` patches of one image and
    ``cc`` channels, runs ``threads`` threads on ``smem`` bytes of shared
    memory, and stages with 16-byte copies if ``vec``."""
    tpy: int
    tpx: int
    cc: int
    threads: int
    smem: int
    vec: bool


def _border(p: int) -> tuple[int, int]:
    """Patches a tile's halo reaches before the tile (LO) and in all beyond
    the tile's own (E): the 3-site border spans ceil(3/p) patches before and
    ends 2 // p patches past the tile (``Side<P>`` in the kernel)."""
    lo = -(-3 // p)
    return lo, lo + 2 // p + 1


def smem_bytes(p: int, tpy: int, tpx: int, cc: int, elem_bytes: int, bwd: bool) -> int:
    """Shared memory of one block, as ``smem_layout`` in the kernel lays it
    out: the halo in the activation dtype (16-byte aligned), the f32 taps,
    the backward's (C, 51) f32 sums, the patch lookup and the visible list."""
    _, e = _border(p)
    halo = -(-(tpy * p + KS - 1) * (tpx * p + KS - 1) * cc * elem_bytes // 16) * 16
    red = _RED_PITCH * cc * 4 if bwd else 0
    return halo + KS * KS * cc * 4 + red + (tpy + e) * (tpx + e) * 4 + 2 * tpy * tpx * 4


def tile_window(p: int, grid: int, tpy: int, tpx: int, tile: int) -> dict:
    """Where tile ``tile`` (row-major over the image's tiles of tpy x tpx
    patches) lies, as the kernel's ``setup_tile`` and ``stage_halo`` find
    it: its patches, clipped at the image's edge; its halo's sites (the
    tile's sites and a 3-site border, which may lie outside the image); and
    the patches the halo reaches, whose ``inv_ids`` the block looks up.
    Each is a pair of half-open ranges (rows, columns)."""
    tiles_x = -(-grid // tpx)
    ty, tx = divmod(tile, tiles_x)
    py0, px0 = ty * tpy, tx * tpx
    py1, px1 = min(py0 + tpy, grid), min(px0 + tpx, grid)
    lo, e = _border(p)
    return {"patches": ((py0, py1), (px0, px1)),
            "halo": ((py0 * p - 3, py1 * p + 3), (px0 * p - 3, px1 * p + 3)),
            "reach": ((py0 - lo, py1 - lo + e), (px0 - lo, px1 - lo + e))}


def _chunks(c: int, elem_bytes: int) -> list[int]:
    """Candidate channel chunks, best first: divisors of C up to
    ``_MAX_CHUNK``, largest first, those a 16-byte copy can stage first."""
    divs = [d for d in range(min(c, _MAX_CHUNK), 0, -1) if c % d == 0]
    return sorted(divs, key=lambda d: (c * elem_bytes % 16 != 0 or d * elem_bytes % 16 != 0))


@functools.lru_cache(maxsize=None)
def tile_plan(p: int, grid: int, c: int, elem_bytes: int, n: int, bwd: bool,
              smem_optin: int, sms: int) -> TilePlan:
    """The launch shape of one direction at patch side p on a grid x grid
    image of C channels and batch N, on a card whose blocks may opt in to
    ``smem_optin`` bytes of shared memory and that has ``sms`` SMs.

    The chunk is the largest divisor of C up to 64 channels (one a 16-byte
    copy can stage where C allows).  The tile is the one whose halos, summed
    over the image, stage the fewest sites, among those that leave room for
    two blocks an SM and give the launch at least ``_BLOCKS_PER_SM`` blocks
    an SM (else as many as any does): larger tiles ran faster on an H100
    than smaller ones at more blocks an SM.  The threads cover the tile's
    work items, 64 to 256."""
    limit = smem_optin // 2 - 1024  # two blocks an SM, 1 KB each reserved
    for cc in _chunks(c, elem_bytes):
        best = None
        for tpy in range(1, grid + 1):
            for tpx in range(1, grid + 1):
                smem = smem_bytes(p, tpy, tpx, cc, elem_bytes, bwd)
                if smem > limit:
                    continue
                tiles = -(-grid // tpy) * -(-grid // tpx)
                halos = (tile_window(p, grid, tpy, tpx, t)["halo"] for t in range(tiles))
                staged = sum((y1 - y0) * (x1 - x0) for (y0, y1), (x0, x1) in halos)
                blocks = n * tiles * (c // cc)
                key = (blocks < _BLOCKS_PER_SM * sms, staged, -blocks)
                if best is None or key < best[0]:
                    best = (key, tpy, tpx, smem)
        if best is not None:
            _, tpy, tpx, smem = best
            per_thread = 2 if elem_bytes == 2 and cc % 2 == 0 else 1
            items = tpy * tpx * (p // _ROWS[p]) * (cc // per_thread)
            threads = min(_MAX_THREADS, max(64, -(-items // 32) * 32))
            vec = c * elem_bytes % 16 == 0 and cc * elem_bytes % 16 == 0
            return TilePlan(tpy, tpx, cc, threads, smem, vec)
    raise ValueError(f"dwconv7_gathered: no tile of p = {p}, C = {c} fits {smem_optin} bytes")


def _card(device) -> tuple[int, int]:
    """(opt-in shared memory per block, SMs) of the card, once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _CARDS:
        with torch.cuda.device(idx):
            optin = _lib().mm_dwconv7_smem_optin()
        _CARDS[idx] = (optin, torch.cuda.get_device_properties(idx).multi_processor_count)
    return _CARDS[idx]


def _lib():
    return _build.library("wholeblock", _SIGNATURES)


def _check(x_g, kept_ids, inv_ids, weight, bias, grid: int, name: str):
    """x_g contiguous (N, K, p, p, C) bf16 or f32 with p in 1/2/4/8/16; the ids
    contiguous int32 (N, K) and (N, grid^2); the params, which the kernels
    read as they are, contiguous f32 (C, 1, 7, 7) and (C,) (no bias in the
    backward); all on x_g's device."""
    if x_g.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {x_g.dtype} not supported (bfloat16, float32)")
    n, k, p, p2, c = x_g.shape
    if p != p2 or p not in _ROWS or not x_g.is_contiguous():
        raise ValueError(f"{name}: x_g must be contiguous (N, K, p, p, C) with p in 1, 2, 4, "
                         f"8, 16, got {tuple(x_g.shape)}")
    dev = x_g.device
    for t, dtype, shape in ((kept_ids, torch.int32, (n, k)),
                            (inv_ids, torch.int32, (n, grid * grid)),
                            (weight, torch.float32, (c, 1, KS, KS)), (bias, torch.float32, (c,))):
        if t is not None and (t.dtype != dtype or t.shape != shape or not t.is_contiguous()
                              or t.device != dev):
            raise ValueError(f"{name}: ids and params must be contiguous {dtype} {shape} on "
                             f"{dev}")


def launch_plan(x_g, grid: int, bwd: bool) -> TilePlan:
    """The tile plan of one direction for x_g's shape and dtype on its card."""
    n, _, p, _, c = x_g.shape
    return tile_plan(p, grid, c, x_g.element_size(), n, bwd, *_card(x_g.device))


def _config(x_g, grid: int, bwd: bool) -> int:
    """Address of the C entry's int arguments for x_g's shape on its card (N,
    K, p, grid, C, the plan's cc, tpy, tpx, threads, smem and vec, is_bf16),
    made once per shape: one pointer crosses ctypes in place of twelve ints."""
    key = (x_g.shape, x_g.dtype, grid, bwd, x_g.get_device())
    cfg = _CONFIGS.get(key)
    if cfg is None:
        n, k, p, _, c = x_g.shape
        plan = launch_plan(x_g, grid, bwd)
        cfg = (ctypes.c_int * 12)(n, k, p, grid, c, plan.cc, plan.tpy, plan.tpx, plan.threads,
                                  plan.smem, int(plan.vec), int(x_g.dtype == torch.bfloat16))
        _CONFIGS[key] = cfg
    return ctypes.addressof(cfg)


def _fwd_cuda(x_g, kept_ids, inv_ids, weight, bias, grid: int):
    _check(x_g, kept_ids, inv_ids, weight, bias, grid, "dwconv7_gathered")
    out = torch.empty_like(x_g)
    err = _lib().mm_dwconv7_fwd(x_g.data_ptr(), inv_ids.data_ptr(), weight.data_ptr(),
                                bias.data_ptr(), out.data_ptr(), _config(x_g, grid, False),
                                x_g.get_device(), _build.stream_ptr(x_g.device))
    _build.check(err, "mm_dwconv7_fwd")
    LAUNCHES["dwconv7_gathered_fwd"] += 1
    return out


def _bwd_cuda(dt, x_g, kept_ids, inv_ids, weight, grid: int):
    _check(x_g, kept_ids, inv_ids, weight, None, grid, "dwconv7_gathered backward")
    if (dt.shape != x_g.shape or dt.dtype != x_g.dtype or not dt.is_contiguous()
            or dt.device != x_g.device):
        raise ValueError("dwconv7_gathered backward: dt must match x_g")
    c = x_g.shape[-1]
    dx = torch.empty_like(x_g)
    dkdb = torch.empty(c * (KS * KS + 1), dtype=torch.float32, device=x_g.device)
    err = _lib().mm_dwconv7_bwd(dt.data_ptr(), x_g.data_ptr(), inv_ids.data_ptr(),
                                weight.data_ptr(), dx.data_ptr(), dkdb.data_ptr(),
                                _config(x_g, grid, True), x_g.get_device(),
                                _build.stream_ptr(x_g.device))
    _build.check(err, "mm_dwconv7_bwd")
    LAUNCHES["dwconv7_gathered_bwd"] += 1
    return dx, dkdb[:c * KS * KS].view(c, 1, KS, KS), dkdb[c * KS * KS:]


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

"""``stem_rows``: the gathered encoder's stem on the visible patches.

The stem's site-local part -- LN -> erf GELU -> depthwise s x s stride-s
conv -> LN -- applied to the initial 3x3 conv's output ``y`` (N, H, W, C) at
the K visible patches of each sample only, giving the ``(N, K, P/s, P/s, C)``
rows that ``gather_patches`` gives of the dense stem (P = H / grid, the
input side of a patch).  The s x s stride-s conv never crosses a patch, so
running it on the gathered patches computes the same rows (the JAX
package's ``stem_gathered``, ``convnextv2.py:758-765``).  Statistics and
sums are f32; the LN outputs, the GELU, the conv output (taps and bias
rounded to the activation dtype) and the rows are rounded to the activation
dtype, where the composed stem rounds them.

On a CUDA tensor both directions go to the kernels in ``csrc/stem.cu``, one
launch each: the forward reads ``y`` at the visible patches and writes the
rows; the backward recomputes the forward from ``y`` (the one tensor saved),
writes the dense ``d(y)`` with zeros at removed patches, and gives the six
leaves' gradients as f32 sums (LN1's weight and bias, the taps and their
bias, LN2's weight and bias).  On a CPU tensor the op is
:func:`stem_rows_plain`, the same math composed of torch ops on the dense
grid and then gathered, which autograd differentiates.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .patch_select import gather_patches_plain

# launches of each CUDA kernel (a plain count, read by chip_smoke.py)
LAUNCHES = {"stem_rows_fwd": 0, "stem_rows_bwd": 0}

STRIDES = (1, 2)  # stem strides the kernels take (the kernel's taps: 1, 4)
GROUPS = (4, 8, 16, 32)  # lanes a site (the kernel's G)
MAX_PAIRS = 6  # channel pairs a lane (the kernel's NP instantiations: 1 to 6)
# pairs a lane past which a group of fewer than 32 lanes is not taken, by
# taps: the backward keeps (5 + taps) sums and the taps' inputs a pair
PAIRS_CAP = {1: 5, 4: 3}
MAX_C = 2 * MAX_PAIRS * GROUPS[-1]
HEAD = 5  # param rows before the taps: LN1 weight, LN1 bias, tap bias, LN2 weight, LN2 bias
WARPS = 4  # a block (the kernel's WARPS); a warp computes one patch row at a time
BLOCK_GROUP = 16  # the backward's partial rows a group row adds (the kernel's BLOCK_GROUP)
_F = ctypes.c_float
_SIGNATURES = {
    "mm_stem_rows_fwd": [_build.P] * 5 + [_F, _F, _build.I, _build.P],
    "mm_stem_rows_bwd": [_build.P] * 10 + [_F, _F, _build.I, _build.P],
    "mm_stem_occupancy": [_build.I] * 5,
}
_SMS: dict[int, int] = {}  # device index -> SMs
_CONFIGS: dict = {}  # launch key -> the C entry's int arguments


def supported(c: int, s: int) -> bool:
    """Whether the kernels take a stem of ``c`` channels and stride ``s``."""
    return s in STRIDES and c % 2 == 0 and 2 <= c <= MAX_C


def lane_plan(c: int, taps: int) -> tuple[int, int]:
    """(lanes a site G, channel pairs a lane) for ``c`` channels and
    ``taps`` taps: the fewest pairs left idle, then the smallest group (more
    sites a warp, fewer shuffles a sum), among the groups whose pairs a lane
    stay within ``PAIRS_CAP`` (any up to ``MAX_PAIRS`` for a whole warp)."""
    best = None
    for g in GROUPS:
        n = -(-c // (2 * g))
        if n > (MAX_PAIRS if g == GROUPS[-1] else PAIRS_CAP[taps]):
            continue
        key = (2 * g * n - c, g)
        if best is None or key < best[0]:
            best = (key, g, n)
    return best[1], best[2]


# ---------------------------------------------------------------------------
# plain version (composed torch ops)
# ---------------------------------------------------------------------------
def _layer_norm(x, weight, bias, eps: float, dtype):
    """``models/norm.py::LayerNorm``'s math: f32 statistics over the last
    axis, the affine in f32, the output in ``dtype``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) / torch.sqrt(var + eps) * weight + bias).to(dtype)


def stem_rows_plain(y, kept_ids, grid: int, s: int, ln1_w, ln1_b, tap_w, tap_b, ln2_w, ln2_b,
                    eps1: float = 1e-6, eps2: float = 1e-6):
    """The composed stem on the dense grid, then the gather of the
    ``kept_ids`` patches' rows, all differentiable: the route the gathered
    encoder took before the kernels, whose rows equal those of the stem run
    on the gathered patches (the conv never crosses a patch).  The conv
    takes the dtype's values and rounded taps and bias in f32 (exact
    products, f32 sums; on a card cuDNN's TF32 holds a bf16 value exactly,
    an f32 one only with TF32 off), rounded once.  Dense, so that a FLOP
    count of the step (``utils/flops.py``) sees the model's stem conv as
    the reference's does."""
    dt = y.dtype
    c = y.shape[-1]
    g = F.gelu(_layer_norm(y, ln1_w, ln1_b, eps1, dt)).float().permute(0, 3, 1, 2)
    z = F.conv2d(g, tap_w.to(dt).float(), tap_b.to(dt).float(), stride=s, groups=c)
    z = _layer_norm(z.permute(0, 2, 3, 1).to(dt), ln2_w, ln2_b, eps2, dt)
    return gather_patches_plain(z, kept_ids, z.shape[1] // grid, grid)


def param_rows(ln1_w, ln1_b, tap_w, tap_b, ln2_w, ln2_b, dtype) -> torch.Tensor:
    """The kernels' params: (5 + s*s, C) f32, rows LN1 weight, LN1 bias, tap
    bias, LN2 weight, LN2 bias, then the taps in row-major order; the tap
    bias and the taps rounded to the activation ``dtype``, as the conv
    takes them."""
    c = ln1_w.shape[0]
    tap_b = tap_b.to(dtype).float()
    head = torch.stack([ln1_w.float(), ln1_b.float(), tap_b, ln2_w.float(), ln2_b.float()])
    return torch.cat([head, tap_w.reshape(c, -1).t().to(dtype).float()]).contiguous()


def leaf_grads(g: torch.Tensor, s: int):
    """:func:`param_rows`-shaped gradients -> (LN1 weight, LN1 bias, taps
    (C, 1, s, s), tap bias, LN2 weight, LN2 bias)."""
    c = g.shape[1]
    return g[0], g[1], g[HEAD:].t().reshape(c, 1, s, s), g[2], g[3], g[4]


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------
def _entry(name: str):
    return getattr(_build.library("stem", _SIGNATURES), name)


def _sms(device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def launch_blocks(y, units: int, taps: int, bwd: bool) -> int:
    """One wave of blocks over ``units`` patch rows (one a warp at a time)
    on y's card: the SMs times the blocks an SM holds."""
    c = y.shape[-1]
    with torch.cuda.device(y.device):
        occ = _entry("mm_stem_occupancy")(int(bwd), int(y.dtype == torch.bfloat16),
                                          lane_plan(c, taps)[1], taps, c)
    _build.check(-occ if occ < 0 else 0, "mm_stem_occupancy")
    if occ == 0:
        raise ValueError(f"stem_rows: no kernel for C = {c} and {taps} taps")
    return max(1, min(_sms(y.device) * occ, -(-units // WARPS)))


def _config(y, k: int, grid: int, s: int, bwd: bool) -> tuple[int, int]:
    """(address of the C entry's ``Config``, blocks) for this launch, made
    once per (direction, shape, dtype, K, grid, s, device)."""
    key = (bwd, y.shape, y.dtype, k, grid, s, y.get_device())
    hit = _CONFIGS.get(key)
    if hit is None:
        n, h, w, c = y.shape
        p = h // grid
        q = p // s
        blocks = launch_blocks(y, n * k * q, s * s, bwd)
        group, pairs = lane_plan(c, s * s)
        cfg = (ctypes.c_int * 14)(n, k, grid * grid, h, w, c, grid, p, q, pairs, s * s, blocks,
                                  int(y.dtype == torch.bfloat16), group)
        hit = _CONFIGS[key] = (cfg, blocks)
    return ctypes.addressof(hit[0]), hit[1]


def _check(y, kept_ids, inv_ids, grid: int, s: int) -> None:
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"stem_rows: dtype {y.dtype} not supported (bfloat16, float32)")
    n, h, w, c = y.shape
    if not supported(c, s):
        raise ValueError(f"stem_rows: no kernel for C = {c}, s = {s} (C even, <= {MAX_C}; "
                         f"s in {STRIDES})")
    if h != w or h % grid or (h // grid) % s:
        raise ValueError(f"stem_rows: shape {tuple(y.shape)} vs grid={grid} s={s}")
    if not y.is_contiguous() or y.data_ptr() % (2 * y.element_size()):
        raise ValueError("stem_rows: y must be contiguous NHWC, aligned to a pair of channels")
    for ids, width in ((kept_ids, kept_ids.shape[-1]), (inv_ids, grid * grid)):
        if (ids.dtype != torch.int32 or not ids.is_contiguous() or ids.device != y.device
                or ids.shape != (n, width)):
            raise ValueError(f"stem_rows: ids must be contiguous int32 (N, {width}) on {y.device}")


def _fwd_cuda(y, kept_ids, prm, grid: int, s: int, eps1: float, eps2: float):
    n, c, k = y.shape[0], y.shape[-1], kept_ids.shape[1]
    q = y.shape[1] // grid // s
    rows = torch.empty((n, k, q, q, c), dtype=y.dtype, device=y.device)
    if rows.numel():
        cfg, _ = _config(y, k, grid, s, False)
        err = _entry("mm_stem_rows_fwd")(y.data_ptr(), kept_ids.data_ptr(), prm.data_ptr(),
                                         rows.data_ptr(), cfg, eps1, eps2, y.get_device(),
                                         _build.stream_ptr(y.device))
        _build.check(err, "mm_stem_rows_fwd")
        LAUNCHES["stem_rows_fwd"] += 1
    return rows


def _bwd_cuda(y, drows, kept_ids, inv_ids, prm, grid: int, s: int, eps1: float, eps2: float):
    """(dense d(y), :func:`param_rows`-shaped f32 gradients)."""
    if drows.dtype != y.dtype or drows.shape[:2] != kept_ids.shape:
        raise ValueError(f"stem_rows: cotangent {tuple(drows.shape)} {drows.dtype} does not "
                         f"match the rows")
    if drows.data_ptr() % (2 * drows.element_size()):
        drows = drows.clone()
    k = kept_ids.shape[1]
    dy = torch.empty_like(y)
    cfg, blocks = _config(y, k, grid, s, True)
    groups = -(-blocks // BLOCK_GROUP)
    part = torch.empty((blocks + groups, prm.numel()), dtype=torch.float32, device=y.device)
    grads = torch.empty_like(prm)
    ticket = torch.empty(groups + 1, dtype=torch.int32, device=y.device)
    err = _entry("mm_stem_rows_bwd")(y.data_ptr(), drows.data_ptr(), kept_ids.data_ptr(),
                                     inv_ids.data_ptr(), prm.data_ptr(), dy.data_ptr(), part.data_ptr(),
                                     grads.data_ptr(), ticket.data_ptr(), cfg, eps1, eps2,
                                     y.get_device(), _build.stream_ptr(y.device))
    _build.check(err, "mm_stem_rows_bwd")
    LAUNCHES["stem_rows_bwd"] += 1
    return dy, grads


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------
class _StemRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, kept_ids, inv_ids, grid, s, eps1, eps2, ln1_w, ln1_b, tap_w, tap_b,
                ln2_w, ln2_b):
        prm = param_rows(ln1_w, ln1_b, tap_w, tap_b, ln2_w, ln2_b, y.dtype)
        ctx.save_for_backward(y, kept_ids, inv_ids, prm)
        ctx.geom = (grid, s, eps1, eps2)
        return _fwd_cuda(y, kept_ids, prm, grid, s, eps1, eps2)

    @staticmethod
    def backward(ctx, drows):
        y, kept_ids, inv_ids, prm = ctx.saved_tensors
        grid, s, eps1, eps2 = ctx.geom
        dy, grads = _bwd_cuda(y, drows.contiguous(), kept_ids, inv_ids, prm, grid, s, eps1, eps2)
        return (dy, None, None, None, None, None, None, *leaf_grads(grads, s))


def stem_rows(y, kept_ids, inv_ids, grid: int, s: int, ln1_w, ln1_b, tap_w, tap_b, ln2_w,
              ln2_b, eps1: float = 1e-6, eps2: float = 1e-6):
    """The ``(N, K, P/s, P/s, C)`` stem rows of the ``kept_ids`` (N, K)
    visible patches of ``y`` (N, H, W, C), the initial conv's output on a
    ``grid`` x ``grid`` grid of patches (``inv_ids`` (N, grid^2): each
    patch's row, K where removed), in y's dtype: LN1 (``ln1_w``, ``ln1_b``,
    ``eps1``) -> erf GELU -> the depthwise s x s stride-s conv (``tap_w``
    (C, 1, s, s), ``tap_b``) -> LN2 (``ln2_w``, ``ln2_b``, ``eps2``).  The
    plain version on a CPU tensor, the kernels on a CUDA tensor."""
    if y.device.type == "cpu":
        return stem_rows_plain(y, kept_ids, grid, s, ln1_w, ln1_b, tap_w, tap_b, ln2_w, ln2_b,
                               eps1, eps2)
    if not y.is_cuda:
        raise RuntimeError(f"stem_rows: no kernel for device {y.device}")
    _check(y, kept_ids, inv_ids, grid, s)
    return _StemRows.apply(y, kept_ids, inv_ids, grid, s, float(eps1), float(eps2), ln1_w,
                           ln1_b, tap_w, tap_b, ln2_w, ln2_b)

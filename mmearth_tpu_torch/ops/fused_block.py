"""The fused tails of an encoder block: ``fused_block_mlp_spillg`` on the
gathered rows and ``fused_block_mlp`` on the masked dense grid.

**Spill-g** (port of ``mmearth_tpu/ops/fused_block.py:355-657``).  On the
(M, C) rows of the visible patches it computes

    y = x_res + GRN(gelu(LN(t) W1^T + b1)) W2^T + b2

and its VJP.  LN and GRN have eps 1e-6.  Every product rounds its operands to
the activation dtype and sums in f32, as ``_mm`` does (``fused_block.py:69-81``).
``g = gelu(v)`` is stored ("spilled") in the activation dtype between the
phases, and the GRN sum of squares is taken over the stored value.  The GRN
statistic is taken per group of ``group_rows`` consecutive rows (one group of
samples, ``MaskedGRN(group)``); with one group this is the JAX kernel's
global statistic.  The JAX kernel declines ``grn_group != 0``; this port takes
the group.

Phases, as in JAX (each a plain function here, and CUDA launches in
``csrc/fused_block.cu``):

  A  LN -> W1 -> GELU, stores g, sum g^2 per group     (``_sg_fwd_a_kernel``)
  B  gx = sqrt, nx, GRN apply -> W2 -> + residual      (``_sg_fwd_b_kernel``)
  C  dh = dy W2; dgamma, dbeta, dnx, db2; dW2 = h^T dy (``_sg_bwd_c_kernel``)
     -- the (G, 4C) dgx step, plain torch on every device, as JAX leaves it
        to XLA (``fused_block.py:602-606``)
  D  recompute u, v, dh; dv; db1, dLN, dt; dW1 = dv^T u (``_sg_bwd_d_kernel``)

On the card C and D are two launches each: a row pass and a split-over-rows
``X^T Y`` pass for the weight gradient (``spillg_bwd_c_dw2`` from dy and h,
``spillg_bwd_d_dw1`` from the dv and u that the row pass of D stores).

**Masked dense** (port of ``fused_block_mlp``, ``fused_block.py:87-354``, the
tail of ``--sparse_impl masked_dense --block_impl fused``).  On the (M, C)
sites of the dense grid, with ``keep`` (M, 1), 1 = visible:

    y = x_res + keep * (GRN_keep(gelu(LN(t) W1^T + b1)) W2^T + b2)

where the GRN sum of squares is over ``g * keep`` of the f32 ``g`` (never
rounded for storage; ``fused_block_mlp_reference``, :663-675).  As in the
Pallas kernel, g is recomputed in every pass instead of stored:

  stat   LN -> W1 -> GELU, sum (g keep)^2 per group          (``_fwd_kernel``
  apply  again, GRN apply -> W2 -> y = x + o keep              phases 0, 1)
  bstat  do = dy keep; v, g, dh = do W2, h; dgamma, dbeta, dnx, db2; stores
         do and h, and dW2 = do^T h is a second launch      (``_bwd_kernel``
     -- the dgx step, shared with spill-g                     phase 0,
  dv     D on do, with g keep^2 in the dgx term; dW1 = dv^T u  phase 1)

Masked rows give y = x_res exactly, dt = 0, and add nothing to any sum.
``d x_res = dy``; ``keep`` takes no gradient (:345-351).

GELU is the exact erf form: ``erff`` on the card and ``torch.erf`` on the CPU,
where the Pallas kernels use a polynomial with an absolute error of 1.5e-7.

Params are taken in the port's layout: ``nn.Linear`` weights (out, in), the
GRN affines (1, 1, 1, 4C); the gradients come back in the same layout.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from . import _build

LN_EPS = 1e-6
GRN_EPS = 1e-6
_SQRT_HALF = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

# launches of each CUDA kernel (a plain count, read by chip_smoke.py)
SPILLG_LAUNCHES = ("spillg_fwd_a", "spillg_fwd_b", "spillg_bwd_c", "spillg_bwd_c_dw2",
                   "spillg_bwd_d", "spillg_bwd_d_dw1")
MASKED_LAUNCHES = ("masked_fwd_stat", "masked_fwd_apply", "masked_bwd_stat",
                   "masked_bwd_stat_dw2", "masked_bwd_dv", "masked_bwd_dv_dw1")
LAUNCHES = dict.fromkeys(SPILLG_LAUNCHES + MASKED_LAUNCHES, 0)

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "mm_spillg_fwd_a": [_P] * 7 + [_I] * 4 + [_P],
    "mm_spillg_fwd_b": [_P] * 10 + [_I] * 4 + [_P],
    "mm_spillg_bwd_c": [_P] * 9 + [_I] * 4 + [_P],
    "mm_spillg_bwd_d": [_P] * 19 + [_I] * 4 + [_P],
    "mm_spillg_atb": [_P] * 6 + [_I] * 7 + [_P],
    "mm_masked_fwd_stat": [_P] * 7 + [_I] * 4 + [_P],
    "mm_masked_fwd_apply": [_P] * 17 + [_I] * 4 + [_P],
    "mm_masked_bwd_stat": [_P] * 18 + [_I] * 4 + [_P],
    "mm_masked_bwd_dv": [_P] * 19 + [_I] * 4 + [_P],
    "mm_fused_wide_bm": [_I] * 3,
}
_ATB_BLOCKS = 528  # X^T Y blocks to aim for (4 per SM on 132 SMs)
_ATB_CHUNK = 64    # rows staged per step of the X^T Y kernel


# ---------------------------------------------------------------------------
# plain versions (follow fused_block_mlp_spillg_reference step for step)
# ---------------------------------------------------------------------------
def _cd(dtype):
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _mm(a, b, cd):
    """a @ b with operands rounded to ``cd`` and f32 sums (needs TF32 off on
    the card: a bf16 matmul would round its output to bf16)."""
    return a.to(cd).float() @ b.to(cd).float()


def _ln(t32, w, b):
    mu = t32.mean(-1, keepdim=True)
    var = (t32 - mu).square().mean(-1, keepdim=True)
    r = torch.rsqrt(var + LN_EPS)
    uhat = (t32 - mu) * r
    return uhat * w.float() + b.float(), uhat, r


def _gelu(v):
    return 0.5 * v * (1.0 + torch.erf(v * _SQRT_HALF))


def _gelu_grad(v):
    return 0.5 * (1.0 + torch.erf(v * _SQRT_HALF)) + v * torch.exp(-0.5 * v * v) * _INV_SQRT_2PI


def _per_row(stat, group_rows):
    """(G, 4C) group statistic -> (M, 4C) rows."""
    return stat.repeat_interleave(group_rows, dim=0)


def h_plain(g, nx, gamma, beta, group_rows):
    """GRN apply in f32: gamma * (g * nx) + beta + g."""
    gf = g.float()
    return gamma.float() * (gf * _per_row(nx, group_rows)) + beta.float() + gf


def fwd_a_plain(t, ln_w, ln_b, w1, b1, group_rows):
    """-> g (M, 4C) in t.dtype, gxsq (G, 4C) f32."""
    u, _, _ = _ln(t.float(), ln_w, ln_b)
    g = _gelu(_mm(u, w1.t(), _cd(t.dtype)) + b1.float()).to(t.dtype)
    gf = g.float()
    return g, (gf * gf).reshape(-1, group_rows, gf.shape[-1]).sum(1)


def fwd_b_plain(g, x_res, gxsq, gamma, beta, w2, b2, group_rows):
    """-> y (M, C) in g.dtype, gx and nx (G, 4C) f32."""
    gx = torch.sqrt(gxsq)
    nx = gx / (gx.mean(-1, keepdim=True) + GRN_EPS)
    o = _mm(h_plain(g, nx, gamma, beta, group_rows), w2.t(), _cd(g.dtype)) + b2.float()
    return (x_res.float() + o).to(g.dtype), gx, nx


def bwd_c_plain(dy, g, nx, gamma, w2, group_rows):
    """Phase C's row sums -> db2 (C,), dgamma, dbeta (4C,), dnx (G, 4C)."""
    dh = _mm(dy, w2, _cd(dy.dtype))
    gf, nxr = g.float(), _per_row(nx, group_rows)
    dnx = (dh * gamma.float() * gf).reshape(-1, group_rows, gf.shape[-1]).sum(1)
    return dy.float().sum(0), (dh * (gf * nxr)).sum(0), dh.sum(0), dnx


def atb_plain(x, y):
    """x^T y with operands rounded to their dtype's product type, f32 sums."""
    return _mm(x.t(), y, _cd(x.dtype))


def dw2_plain(dy, g, nx, gamma, beta, group_rows):
    """dW2 = h^T dy with h recomputed from g, (C, 4C) f32."""
    return atb_plain(dy, h_plain(g, nx, gamma, beta, group_rows))


def dgx_step(dnx, gx):
    """dgx / gx from dnx (tiny, (G, 4C)), 0 where gx == 0; plain torch on every
    device, as JAX computes it in XLA (``fused_block.py:602-606``)."""
    denom = gx.mean(-1, keepdim=True) + GRN_EPS
    dgx = dnx / denom - (dnx * gx).sum(-1, keepdim=True) / (denom * denom) / gx.shape[-1]
    pos = gx > 0
    return torch.where(pos, dgx / torch.where(pos, gx, torch.ones_like(gx)), torch.zeros_like(gx))


def _d_rows(t, dy, g_of_v, nx, dgxg, ln_w, ln_b, w1, b1, gamma, w2, group_rows):
    """D's row pass; ``g_of_v(v)`` is the f32 g of the dgx term."""
    cd = _cd(t.dtype)
    u, uhat, r = _ln(t.float(), ln_w, ln_b)
    v = _mm(u, w1.t(), cd) + b1.float()
    dh = _mm(dy, w2, cd)
    dg = (dh * (gamma.float() * _per_row(nx, group_rows) + 1.0)
          + g_of_v(v) * _per_row(dgxg, group_rows))
    dv = dg * _gelu_grad(v)
    du = _mm(dv, w1, cd)
    da = du * ln_w.float()
    dt = r * (da - da.mean(-1, keepdim=True) - uhat * (da * uhat).mean(-1, keepdim=True))
    return dt.to(t.dtype), dv.sum(0), (du * uhat).sum(0), du.sum(0), dv.to(cd), u.to(cd)


def bwd_d_plain(t, dy, g, nx, dgxg, ln_w, ln_b, w1, b1, gamma, w2, group_rows):
    """Phase D but dW1 -> dt (M, C) in t.dtype, db1 (4C,), dln_w, dln_b (C,),
    and dv, u rounded to the product type (dW1 = ``atb_plain(dv, u)``)."""
    return _d_rows(t, dy, lambda v: g.float(), nx, dgxg, ln_w, ln_b, w1, b1, gamma, w2,
                   group_rows)


def fused_block_mlp_spillg_plain(t, x_res, ln_w, ln_b, w1, b1, gamma, beta, w2, b2,
                                 group_rows=None):
    """The forward, composed of the plain phases; params in the port's layout."""
    gr = t.shape[0] if group_rows is None else group_rows
    g, gxsq = fwd_a_plain(t, ln_w, ln_b, w1, b1, gr)
    return fwd_b_plain(g, x_res, gxsq, gamma.reshape(-1), beta.reshape(-1), w2, b2, gr)[0]


# masked dense (follow fused_block_mlp_reference and _bwd_kernel step for step;
# keep is (M, 1))
def _g_plain(t, ln_w, ln_b, w1, b1):
    """The f32 g = gelu(LN(t) W1^T + b1) of the rows."""
    u, _, _ = _ln(t.float(), ln_w, ln_b)
    return _gelu(_mm(u, w1.t(), _cd(t.dtype)) + b1.float())


def masked_fwd_stat_plain(t, keep, ln_w, ln_b, w1, b1, group_rows):
    """-> gxsq (G, 4C) f32, the sum of (g keep)^2 per group."""
    gk = _g_plain(t, ln_w, ln_b, w1, b1) * keep.float()
    return (gk * gk).reshape(-1, group_rows, gk.shape[-1]).sum(1)


def masked_fwd_apply_plain(t, x_res, keep, gxsq, ln_w, ln_b, w1, b1, gamma, beta, w2, b2,
                           group_rows):
    """-> y (M, C) in t.dtype, gx and nx (G, 4C) f32."""
    g = _g_plain(t, ln_w, ln_b, w1, b1)
    gx = torch.sqrt(gxsq)
    nx = gx / (gx.mean(-1, keepdim=True) + GRN_EPS)
    o = _mm(h_plain(g, nx, gamma, beta, group_rows), w2.t(), _cd(t.dtype)) + b2.float()
    return (x_res.float() + o * keep.float()).to(t.dtype), gx, nx


def masked_bwd_stat_plain(t, dy, keep, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, group_rows):
    """The backward's first phase but dW2 -> db2 (C,), dgamma, dbeta (4C,),
    dnx (G, 4C), and do = dy keep and h rounded to the product type (dW2 =
    ``atb_plain(do, h)``)."""
    cd = _cd(t.dtype)
    g = _g_plain(t, ln_w, ln_b, w1, b1)
    do = dy.float() * keep.float()
    dh = _mm(do, w2, cd)
    dnx = (dh * gamma.float() * g).reshape(-1, group_rows, g.shape[-1]).sum(1)
    h = h_plain(g, nx, gamma, beta, group_rows)
    return (do.sum(0), (dh * (g * _per_row(nx, group_rows))).sum(0), dh.sum(0), dnx,
            do.to(cd), h.to(cd))


def masked_bwd_dv_plain(t, do, keep, nx, dgxg, ln_w, ln_b, w1, b1, gamma, w2, group_rows):
    """The second phase but dW1, on the stored do: D with g keep^2 in the dgx
    term (``fused_block.py:192``) -> as ``bwd_d_plain``."""
    k = keep.float()
    return _d_rows(t, do, lambda v: _gelu(v) * k * k, nx, dgxg, ln_w, ln_b, w1, b1, gamma, w2,
                   group_rows)


def fused_block_mlp_plain(t, x_res, keep, ln_w, ln_b, w1, b1, gamma, beta, w2, b2,
                          group_rows=None):
    """The masked forward, composed of the plain phases; params in the port's layout."""
    gr = t.shape[0] if group_rows is None else group_rows
    gm, bt = gamma.reshape(-1), beta.reshape(-1)
    gxsq = masked_fwd_stat_plain(t, keep, ln_w, ln_b, w1, b1, gr)
    return masked_fwd_apply_plain(t, x_res, keep, gxsq, ln_w, ln_b, w1, b1, gm, bt, w2, b2,
                                  gr)[0]


# ---------------------------------------------------------------------------
# CUDA launches (one wrapper per kernel, each counts its launch)
# ---------------------------------------------------------------------------
def _lib():
    return _build.library("fused_block", _SIGNATURES)


def _dev_call(name, key, device, *args):
    with torch.cuda.device(device):
        err = getattr(_lib(), name)(*args, _build.stream_ptr(device))
    _build.check(err, name)
    LAUNCHES[key] += 1


def _rows(t, name):
    if t.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: dtype {t.dtype} not supported (bfloat16, float32)")
    if t.dim() != 2 or not t.is_contiguous() or not t.is_cuda or t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be a contiguous, 16-byte aligned 2-D CUDA tensor")
    return t.shape


def _like(a, ref, shape, name):
    if tuple(a.shape) != tuple(shape) or a.dtype != ref.dtype or a.device != ref.device \
            or not a.is_contiguous() or a.data_ptr() % 16:
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned {ref.dtype} "
                         f"{tuple(shape)} on {ref.device}, got {a.dtype} {tuple(a.shape)} on "
                         f"{a.device}")


def _vec(v, n, dev):
    if v.numel() != n or v.device != dev:
        raise ValueError(f"expected {n} values on {dev}, got {tuple(v.shape)} on {v.device}")
    return v.reshape(-1).float().contiguous()


def _w(w, ref, shape):
    """A weight in ``ref``'s dtype (the product type), contiguous, on its device."""
    if tuple(w.shape) != shape or w.device != ref.device:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device}, expected {shape} on "
                         f"{ref.device}")
    return w.to(ref.dtype).contiguous()


def _check_groups(x, c, group_rows, name):
    """C a multiple of 8; group_rows divides the rows."""
    m = x.shape[0]
    if c % 8:
        raise ValueError(f"{name}: C = {c} must be a multiple of 8")
    if group_rows <= 0 or m % group_rows:
        raise ValueError(f"{name}: group_rows {group_rows} must divide M = {m}")


# the launches that have a wide plan (the kernel's mm_fused_wide_bm kinds)
_WIDE_KINDS = {"spillg_bwd_d": 0, "masked_bwd_dv": 1, "masked_fwd_apply": 2,
               "masked_bwd_stat": 3}
_WIDE_BM: dict = {}  # (device, dtype, launch, C) -> the wide plan's row tile, 0 if resident


def _wide_scratch(t, key, group_rows, acc=True, u=True):
    """The device-memory scratch of a launch whose resident layout does not
    fit its card at t's width (``mm_fused_wide_bm``): its f32 accumulator,
    one slice of BM x C (rounded up to 16) per row block, and the (M, C) u
    in t's dtype, each where asked for; (None, None) where the resident plan
    fits."""
    m, c = t.shape
    cache = (t.device, t.dtype, key, c)
    bm = _WIDE_BM.get(cache)
    if bm is None:
        with torch.cuda.device(t.device):
            bm = _lib().mm_fused_wide_bm(_WIDE_KINDS[key], c, int(t.dtype == torch.bfloat16))
        _WIDE_BM[cache] = bm
    if bm == 0:
        return None, None
    rows = (m // group_rows) * -(-group_rows // bm) * bm
    acc_t = torch.empty((rows, -(-c // 16) * 16), dtype=torch.float32, device=t.device) \
        if acc else None
    return acc_t, torch.empty_like(t) if u else None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_a_cuda(t, ln_w, ln_b, w1, b1, group_rows):
    m, c = _rows(t, "spillg fwd A")
    _check_groups(t, c, group_rows, "spillg fwd A")
    dev, c4 = t.device, 4 * c
    g = torch.empty((m, c4), dtype=t.dtype, device=dev)
    gxsq = torch.zeros((m // group_rows, c4), dtype=torch.float32, device=dev)
    lw, lb, bb = _vec(ln_w, c, dev), _vec(ln_b, c, dev), _vec(b1, c4, dev)
    w = _w(w1, t, (c4, c))
    _dev_call("mm_spillg_fwd_a", "spillg_fwd_a", dev, t.data_ptr(), lw.data_ptr(),
              lb.data_ptr(), w.data_ptr(), bb.data_ptr(), g.data_ptr(), gxsq.data_ptr(),
              m, c, group_rows, int(t.dtype == torch.bfloat16))
    return g, gxsq


def _fwd_b_cuda(g, x_res, gxsq, gamma, beta, w2, b2, group_rows):
    m, c4 = _rows(g, "spillg fwd B")
    c = c4 // 4
    _check_groups(g, c, group_rows, "spillg fwd B")
    _like(x_res, g, (m, c), "spillg fwd B x_res")
    dev, n_g = g.device, m // group_rows
    if tuple(gxsq.shape) != (n_g, c4) or gxsq.dtype != torch.float32:
        raise ValueError("spillg fwd B: gxsq must be f32 (G, 4C)")
    y = torch.empty((m, c), dtype=g.dtype, device=dev)
    gx = torch.empty((n_g, c4), dtype=torch.float32, device=dev)
    nx = torch.empty_like(gx)
    gm, bt, bb = _vec(gamma, c4, dev), _vec(beta, c4, dev), _vec(b2, c, dev)
    w = _w(w2, g, (c, c4))
    _dev_call("mm_spillg_fwd_b", "spillg_fwd_b", dev, g.data_ptr(), x_res.data_ptr(),
              gxsq.contiguous().data_ptr(), gm.data_ptr(), bt.data_ptr(), w.data_ptr(),
              bb.data_ptr(), y.data_ptr(), gx.data_ptr(), nx.data_ptr(), m, c, group_rows,
              int(g.dtype == torch.bfloat16))
    return y, gx, nx


def _bwd_c_cuda(dy, g, nx, gamma, w2, group_rows):
    m, c = _rows(dy, "spillg bwd C")
    _check_groups(dy, c, group_rows, "spillg bwd C")
    c4, dev = 4 * c, dy.device
    _like(g, dy, (m, c4), "spillg bwd C g")
    f32 = dict(dtype=torch.float32, device=dev)
    db2, dgamma, dbeta = torch.zeros(c, **f32), torch.zeros(c4, **f32), torch.zeros(c4, **f32)
    dnx = torch.zeros((m // group_rows, c4), **f32)
    w2t = _w(w2, dy, (c, c4)).t().contiguous()
    _dev_call("mm_spillg_bwd_c", "spillg_bwd_c", dev, dy.data_ptr(), g.data_ptr(),
              nx.contiguous().data_ptr(), _vec(gamma, c4, dev).data_ptr(), w2t.data_ptr(),
              db2.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), dnx.data_ptr(), m, c,
              group_rows, int(dy.dtype == torch.bfloat16))
    return db2, dgamma, dbeta, dnx


def _atb_cuda(x, y, key, h_of=None):
    """x^T y (f32) over the rows; ``h_of`` = (nx, gamma, beta, group_rows)
    turns y (= g) into h as it is read."""
    m, i = _rows(x, key)
    _, j = _rows(y, key)
    if y.shape[0] != m or y.dtype != x.dtype or y.device != x.device:
        raise ValueError(f"{key}: x and y must share rows, dtype and device")
    dev = x.device
    out = torch.zeros((i, j), dtype=torch.float32, device=dev)
    bm = 64 if x.dtype == torch.bfloat16 else 32
    tiles = -(-i // bm) * -(-j // 64)
    chunks = -(-m // _ATB_CHUNK)
    splits = max(1, min(chunks, _ATB_BLOCKS // tiles))
    rows_per_split = -(-chunks // splits) * _ATB_CHUNK
    splits = -(-m // rows_per_split)
    if h_of is None:
        ptrs, gr = (None, None, None), m
    else:
        nx, gamma, beta, gr = h_of
        keep = (nx.contiguous(), _vec(gamma, j, dev), _vec(beta, j, dev))
        ptrs = tuple(a.data_ptr() for a in keep)
    _dev_call("mm_spillg_atb", key, dev, x.data_ptr(), y.data_ptr(), *ptrs, out.data_ptr(),
              m, i, j, gr, rows_per_split, splits, int(x.dtype == torch.bfloat16))
    return out


def _bwd_d_cuda(t, dy, g, nx, dgxg, ln_w, ln_b, w1, b1, gamma, w2, group_rows):
    """The row pass of D: -> dt, db1, dln_w, dln_b, and the stored dv, u."""
    m, c = _rows(t, "spillg bwd D")
    _check_groups(t, c, group_rows, "spillg bwd D")
    c4, dev = 4 * c, t.device
    _like(dy, t, (m, c), "spillg bwd D dy")
    _like(g, t, (m, c4), "spillg bwd D g")
    f32 = dict(dtype=torch.float32, device=dev)
    dt = torch.empty_like(t)
    dv = torch.empty((m, c4), dtype=t.dtype, device=dev)
    u = torch.empty_like(t)
    db1, dlnw, dlnb = torch.zeros(c4, **f32), torch.zeros(c, **f32), torch.zeros(c, **f32)
    w1c = _w(w1, t, (c4, c))
    w1t = w1c.t().contiguous()
    w2t = _w(w2, t, (c, c4)).t().contiguous()
    acc, _ = _wide_scratch(t, "spillg_bwd_d", group_rows, u=False)
    _dev_call("mm_spillg_bwd_d", "spillg_bwd_d", dev, t.data_ptr(), dy.data_ptr(), g.data_ptr(),
              nx.contiguous().data_ptr(), dgxg.contiguous().data_ptr(),
              _vec(ln_w, c, dev).data_ptr(), _vec(ln_b, c, dev).data_ptr(), w1c.data_ptr(),
              _vec(b1, c4, dev).data_ptr(), _vec(gamma, c4, dev).data_ptr(), w2t.data_ptr(),
              w1t.data_ptr(), dt.data_ptr(), dv.data_ptr(), u.data_ptr(), db1.data_ptr(),
              dlnw.data_ptr(), dlnb.data_ptr(), _ptr(acc), m, c, group_rows,
              int(t.dtype == torch.bfloat16))
    return dt, db1, dlnw, dlnb, dv, u


def _dw2_cuda(dy, g, nx, gamma, beta, group_rows):
    return _atb_cuda(dy, g, "spillg_bwd_c_dw2", (nx, gamma, beta, group_rows))


def _dw1_cuda(dv, u):
    return _atb_cuda(dv, u, "spillg_bwd_d_dw1")


def _keep_rows(keep, t, name):
    """keep as M values in t's dtype, contiguous, on t's device."""
    if keep.numel() != t.shape[0] or keep.device != t.device:
        raise ValueError(f"{name}: keep must hold one value per row ({t.shape[0]}) on "
                         f"{t.device}, got {tuple(keep.shape)} on {keep.device}")
    return keep.reshape(-1).to(t.dtype).contiguous()


def _masked_fwd_stat_cuda(t, keep, ln_w, ln_b, w1, b1, group_rows):
    m, c = _rows(t, "masked fwd stat")
    _check_groups(t, c, group_rows, "masked fwd stat")
    dev, c4 = t.device, 4 * c
    kp = _keep_rows(keep, t, "masked fwd stat")
    gxsq = torch.zeros((m // group_rows, c4), dtype=torch.float32, device=dev)
    lw, lb, bb = _vec(ln_w, c, dev), _vec(ln_b, c, dev), _vec(b1, c4, dev)
    w = _w(w1, t, (c4, c))
    _dev_call("mm_masked_fwd_stat", "masked_fwd_stat", dev, t.data_ptr(), kp.data_ptr(),
              lw.data_ptr(), lb.data_ptr(), w.data_ptr(), bb.data_ptr(), gxsq.data_ptr(), m, c,
              group_rows, int(t.dtype == torch.bfloat16))
    return gxsq


def _masked_fwd_apply_cuda(t, x_res, keep, gxsq, ln_w, ln_b, w1, b1, gamma, beta, w2, b2,
                           group_rows):
    m, c = _rows(t, "masked fwd apply")
    _check_groups(t, c, group_rows, "masked fwd apply")
    _like(x_res, t, (m, c), "masked fwd apply x_res")
    dev, c4, n_g = t.device, 4 * c, m // group_rows
    if tuple(gxsq.shape) != (n_g, c4) or gxsq.dtype != torch.float32:
        raise ValueError("masked fwd apply: gxsq must be f32 (G, 4C)")
    kp = _keep_rows(keep, t, "masked fwd apply")
    y = torch.empty_like(t)
    gx = torch.empty((n_g, c4), dtype=torch.float32, device=dev)
    nx = torch.empty_like(gx)
    w1c, w2c = _w(w1, t, (c4, c)), _w(w2, t, (c, c4))
    acc, u = _wide_scratch(t, "masked_fwd_apply", group_rows)
    _dev_call("mm_masked_fwd_apply", "masked_fwd_apply", dev, t.data_ptr(), x_res.data_ptr(),
              kp.data_ptr(), gxsq.contiguous().data_ptr(), _vec(ln_w, c, dev).data_ptr(),
              _vec(ln_b, c, dev).data_ptr(), w1c.data_ptr(), _vec(b1, c4, dev).data_ptr(),
              _vec(gamma, c4, dev).data_ptr(), _vec(beta, c4, dev).data_ptr(), w2c.data_ptr(),
              _vec(b2, c, dev).data_ptr(), y.data_ptr(), gx.data_ptr(), nx.data_ptr(),
              _ptr(acc), _ptr(u), m, c, group_rows, int(t.dtype == torch.bfloat16))
    return y, gx, nx


def _masked_bwd_stat_cuda(t, dy, keep, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, group_rows):
    """-> db2, dgamma, dbeta, dnx and the stored do, h."""
    m, c = _rows(t, "masked bwd stat")
    _check_groups(t, c, group_rows, "masked bwd stat")
    _like(dy, t, (m, c), "masked bwd stat dy")
    dev, c4 = t.device, 4 * c
    kp = _keep_rows(keep, t, "masked bwd stat")
    f32 = dict(dtype=torch.float32, device=dev)
    do, h = torch.empty_like(t), torch.empty((m, c4), dtype=t.dtype, device=dev)
    db2, dgamma, dbeta = torch.zeros(c, **f32), torch.zeros(c4, **f32), torch.zeros(c4, **f32)
    dnx = torch.zeros((m // group_rows, c4), **f32)
    w2t = _w(w2, t, (c, c4)).t().contiguous()
    _, u = _wide_scratch(t, "masked_bwd_stat", group_rows, acc=False)
    _dev_call("mm_masked_bwd_stat", "masked_bwd_stat", dev, t.data_ptr(), dy.data_ptr(),
              kp.data_ptr(), nx.contiguous().data_ptr(), _vec(ln_w, c, dev).data_ptr(),
              _vec(ln_b, c, dev).data_ptr(), _w(w1, t, (c4, c)).data_ptr(),
              _vec(b1, c4, dev).data_ptr(), _vec(gamma, c4, dev).data_ptr(),
              _vec(beta, c4, dev).data_ptr(), w2t.data_ptr(), do.data_ptr(), h.data_ptr(),
              db2.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), dnx.data_ptr(), _ptr(u), m,
              c, group_rows, int(t.dtype == torch.bfloat16))
    return db2, dgamma, dbeta, dnx, do, h


def _masked_bwd_dv_cuda(t, do, keep, nx, dgxg, ln_w, ln_b, w1, b1, gamma, w2, group_rows):
    """The dv pass on the stored do: -> dt, db1, dln_w, dln_b, and the stored dv, u."""
    m, c = _rows(t, "masked bwd dv")
    _check_groups(t, c, group_rows, "masked bwd dv")
    _like(do, t, (m, c), "masked bwd dv do")
    c4, dev = 4 * c, t.device
    kp = _keep_rows(keep, t, "masked bwd dv")
    f32 = dict(dtype=torch.float32, device=dev)
    dt, u = torch.empty_like(t), torch.empty_like(t)
    dv = torch.empty((m, c4), dtype=t.dtype, device=dev)
    db1, dlnw, dlnb = torch.zeros(c4, **f32), torch.zeros(c, **f32), torch.zeros(c, **f32)
    w1c = _w(w1, t, (c4, c))
    w1t = w1c.t().contiguous()
    w2t = _w(w2, t, (c, c4)).t().contiguous()
    acc, _ = _wide_scratch(t, "masked_bwd_dv", group_rows, u=False)
    _dev_call("mm_masked_bwd_dv", "masked_bwd_dv", dev, t.data_ptr(), do.data_ptr(),
              kp.data_ptr(), nx.contiguous().data_ptr(), dgxg.contiguous().data_ptr(),
              _vec(ln_w, c, dev).data_ptr(), _vec(ln_b, c, dev).data_ptr(), w1c.data_ptr(),
              _vec(b1, c4, dev).data_ptr(), _vec(gamma, c4, dev).data_ptr(), w2t.data_ptr(),
              w1t.data_ptr(), dt.data_ptr(), dv.data_ptr(), u.data_ptr(), db1.data_ptr(),
              dlnw.data_ptr(), dlnb.data_ptr(), _ptr(acc), m, c, group_rows,
              int(t.dtype == torch.bfloat16))
    return dt, db1, dlnw, dlnb, dv, u


def _masked_dw2_cuda(do, h):
    return _atb_cuda(do, h, "masked_bwd_stat_dw2")


def _masked_dw1_cuda(dv, u):
    return _atb_cuda(dv, u, "masked_bwd_dv_dw1")


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------
class Phases(NamedTuple):
    """One device's phase functions, with the plain versions' signatures."""

    fwd_a: Callable
    fwd_b: Callable
    bwd_c: Callable
    dw2: Callable
    bwd_d: Callable
    dw1: Callable


class MaskedPhases(NamedTuple):
    """The masked-dense tail's phase functions, with the plain versions' signatures."""

    stat: Callable
    apply: Callable
    bstat: Callable
    dw2: Callable
    dv: Callable
    dw1: Callable


PLAIN = Phases(fwd_a_plain, fwd_b_plain, bwd_c_plain, dw2_plain, bwd_d_plain, atb_plain)
CUDA = Phases(_fwd_a_cuda, _fwd_b_cuda, _bwd_c_cuda, _dw2_cuda, _bwd_d_cuda, _dw1_cuda)
MASKED_PLAIN = MaskedPhases(masked_fwd_stat_plain, masked_fwd_apply_plain, masked_bwd_stat_plain,
                            atb_plain, masked_bwd_dv_plain, atb_plain)
MASKED_CUDA = MaskedPhases(_masked_fwd_stat_cuda, _masked_fwd_apply_cuda, _masked_bwd_stat_cuda,
                           _masked_dw2_cuda, _masked_bwd_dv_cuda, _masked_dw1_cuda)


def phases(x, masked: bool = False):
    """The plain versions for a CPU tensor, the kernels for a CUDA tensor
    (of the masked-dense tail when ``masked``)."""
    if x.device.type == "cpu":
        return MASKED_PLAIN if masked else PLAIN
    if not x.is_cuda:
        op = "fused_block_mlp" if masked else "fused_block_mlp_spillg"
        raise RuntimeError(f"{op}: no kernel for device {x.device}")
    return MASKED_CUDA if masked else CUDA


class _SpillG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, x_res, ln_w, ln_b, w1, b1, gamma, beta, w2, b2, group_rows):
        ph = phases(t)
        gm, bt = gamma.reshape(-1), beta.reshape(-1)
        g, gxsq = ph.fwd_a(t, ln_w, ln_b, w1, b1, group_rows)
        y, gx, nx = ph.fwd_b(g, x_res, gxsq, gm, bt, w2, b2, group_rows)
        ctx.save_for_backward(t, g, gx, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, b2)
        ctx.group_rows = group_rows
        return y

    @staticmethod
    def backward(ctx, dy):
        t, g, gx, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, b2 = ctx.saved_tensors
        ph, gr = phases(t), ctx.group_rows
        gm, bt = gamma.reshape(-1), beta.reshape(-1)
        dy = dy.contiguous()
        db2, dgamma, dbeta, dnx = ph.bwd_c(dy, g, nx, gm, w2, gr)
        dw2 = ph.dw2(dy, g, nx, gm, bt, gr)
        dgxg = dgx_step(dnx, gx)
        dt, db1, dlnw, dlnb, dv, u = ph.bwd_d(t, dy, g, nx, dgxg, ln_w, ln_b, w1, b1, gm, w2, gr)
        dw1 = ph.dw1(dv, u)
        return (dt, dy, *_param_grads((ln_w, ln_b, w1, b1, gamma, beta, w2, b2),
                                      (dlnw, dlnb, dw1, db1, dgamma, dbeta, dw2, db2)), None)


def _param_grads(params, grads):
    return [g.reshape(p.shape).to(p.dtype) for p, g in zip(params, grads)]


def _group_rows(t, group_rows, op):
    gr = t.shape[0] if group_rows is None else int(group_rows)
    if gr <= 0 or t.shape[0] % gr:
        raise ValueError(f"{op}: group_rows {gr} must divide M = {t.shape[0]}")
    return gr


class _Masked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, x_res, keep, ln_w, ln_b, w1, b1, gamma, beta, w2, b2, group_rows):
        ph = phases(t, masked=True)
        gm, bt = gamma.reshape(-1), beta.reshape(-1)
        gxsq = ph.stat(t, keep, ln_w, ln_b, w1, b1, group_rows)
        y, gx, nx = ph.apply(t, x_res, keep, gxsq, ln_w, ln_b, w1, b1, gm, bt, w2, b2,
                             group_rows)
        ctx.save_for_backward(t, keep, gx, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, b2)
        ctx.group_rows = group_rows
        return y

    @staticmethod
    def backward(ctx, dy):
        t, keep, gx, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, b2 = ctx.saved_tensors
        ph, gr = phases(t, masked=True), ctx.group_rows
        gm, bt = gamma.reshape(-1), beta.reshape(-1)
        dy = dy.contiguous()
        db2, dgamma, dbeta, dnx, do, h = ph.bstat(t, dy, keep, nx, ln_w, ln_b, w1, b1, gm, bt,
                                                  w2, gr)
        dw2 = ph.dw2(do, h)
        dgxg = dgx_step(dnx, gx)
        dt, db1, dlnw, dlnb, dv, u = ph.dv(t, do, keep, nx, dgxg, ln_w, ln_b, w1, b1, gm, w2, gr)
        dw1 = ph.dw1(dv, u)
        return (dt, dy, None, *_param_grads((ln_w, ln_b, w1, b1, gamma, beta, w2, b2),
                                            (dlnw, dlnb, dw1, db1, dgamma, dbeta, dw2, db2)),
                None)


def fused_block_mlp(t, x_res, keep, ln_w, ln_b, w1, b1, gamma, beta, w2, b2, group_rows=None):
    """``x_res + keep * (GRN_keep(gelu(LN(t) W1^T + b1)) W2^T + b2)`` with its
    full VJP, on the (M, C) sites of the masked dense grid.

    t, x_res: (M, C) in the activation dtype (bf16 or f32); keep: M values,
    1 = visible (its GRN statistic is over ``g * keep``; it takes no
    gradient); params as in :func:`fused_block_mlp_spillg`.  ``group_rows``:
    rows per GRN group (it must divide M); None = one group of all rows.  On
    the card C must be a multiple of 8."""
    gr = _group_rows(t, group_rows, "fused_block_mlp")
    keep = keep.detach().reshape(t.shape[0], 1).to(t.dtype).contiguous()
    return _Masked.apply(t.contiguous(), x_res.to(t.dtype).contiguous(), keep, ln_w, ln_b, w1,
                         b1, gamma, beta, w2, b2, gr)


def fused_block_mlp_spillg(t, x_res, ln_w, ln_b, w1, b1, gamma, beta, w2, b2, group_rows=None):
    """``x_res + GRN(gelu(LN(t) W1^T + b1)) W2^T + b2`` with its full VJP.

    t, x_res: (M, C) rows in the activation dtype (bf16 or f32); ln_w, ln_b
    (C,); w1 (4C, C) and b1 (4C,) of ``pwconv1``; gamma, beta (1, 1, 1, 4C);
    w2 (C, 4C) and b2 (C,) of ``pwconv2``; params f32.  ``group_rows``: rows
    per GRN group (it must divide M); None = one group of all rows.  On the
    card C must be a multiple of 8; rows too wide for a launch's resident
    shared-memory layout take its wide plan (``csrc/fused_block.cu``)."""
    gr = _group_rows(t, group_rows, "fused_block_mlp_spillg")
    return _SpillG.apply(t.contiguous(), x_res.to(t.dtype).contiguous(), ln_w, ln_b, w1, b1,
                         gamma, beta, w2, b2, gr)

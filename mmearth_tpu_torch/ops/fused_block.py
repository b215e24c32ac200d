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

On the card every phase is a persistent row pass over every row of each
group, launched from its :class:`TailPlan`: A is the masked statistic pass's
kernel on every row, storing g (rounded to the activation dtype, with the
sum of squares of the stored g); B builds h from the stored g once an
element and sums h W2^T in registers, its output columns split over the
grid where C > 160.  The backward's product operands (W1, W1^T, W2^T in the
activation dtype) are made once per call (:class:`BwdWeights`).  C is one launch where
its slice of dW2 fits the block's registers (every atto width; ``fold`` of
its :class:`TailPlan`), else a row pass and the split-over-rows ``X^T Y``
pass ``spillg_bwd_c_dw2`` from dy and h; D is a row pass (the masked dv
pass's kernel on every row, the stored g in its dgx term) and
``spillg_bwd_d_dw1`` from the dv and u it stores.

**Masked dense** (port of ``fused_block_mlp``, ``fused_block.py:87-354``, the
tail of ``--sparse_impl masked_dense --block_impl fused``).  On the (M, C)
sites of the dense grid, with ``keep`` (M, 1), 1 = visible:

    y = x_res + keep * (GRN_keep(gelu(LN(t) W1^T + b1)) W2^T + b2)

where the GRN sum of squares is over ``g * keep`` of the f32 ``g`` (never
rounded for storage; ``fused_block_mlp_reference``, :663-675).  Masked rows
give y = x_res exactly, dt = 0, and add nothing to any sum; ``d x_res =
dy``; ``keep`` takes no gradient (:345-351).  So the forward first builds the
kept-row list (:func:`kept_rows_plain`: each GRN group cut into chunks of
``ROWS_CHUNK`` rows, each chunk's kept rows then its masked ones, and the
count kept per chunk), saved for the backward, and every pass computes the
kept rows only.  As in the Pallas kernel, g is recomputed in every pass
instead of stored:

  rows   the kept-row list                                    (``_fwd_kernel``
  stat   LN -> W1 -> GELU, sum (g keep)^2 per group            phases 0, 1)
  apply  again, GRN apply -> W2 -> y = x + o keep; y = x at masked rows
  bstat  do = dy keep; v, g, dh = do W2, h; dgamma, dbeta, dnx, db2; stores
         do and h at the list's slots, and dW2 = do^T h over the kept
         slots is a second launch                            (``_bwd_kernel``
     -- the dgx step, shared with spill-g                     phase 0,
  dv     D on do, with g keep^2 in the dgx term; dt = 0 at     phase 1)
         masked rows; dW1 = dv^T u over the kept slots

The ``masked_*_dense`` functions are the same phases on every row, as the
Pallas kernel's dense grid computes them: the reference of the tests.

**Across ranks** (the global GRN scope under a process group, the
``process_group`` argument of both ops): the statistic is the global
batch's, so the (G, 4C) sum of squares is summed over the ranks between
the statistic pass and the pass that applies it (A and B, stat and apply),
and ``dnx`` between the backward's first pass and the dgx step (C or bstat,
then D or dv).  The kernels run unchanged, each on its rank's rows, with
one all-reduce between two launches; the param gradients stay the rank's
own sums, for the optimizer's reduction.

GELU is the exact erf form: ``erff`` on the card and ``torch.erf`` on the CPU,
where the Pallas kernels use a polynomial with an absolute error of 1.5e-7.

Params are taken in the port's layout: ``nn.Linear`` weights (out, in), the
GRN affines (1, 1, 1, 4C); the gradients come back in the same layout.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernels or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple

import torch

from . import _build
from ..parallel.mesh import sum_

LN_EPS = 1e-6
GRN_EPS = 1e-6
_SQRT_HALF = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

# launches of each CUDA kernel (a plain count, read by chip_smoke.py)
SPILLG_LAUNCHES = ("spillg_fwd_a", "spillg_fwd_b", "spillg_bwd_c", "spillg_bwd_c_dw2",
                   "spillg_bwd_d", "spillg_bwd_d_dw1")
MASKED_LAUNCHES = ("masked_rows", "masked_fwd_stat", "masked_fwd_apply", "masked_bwd_stat",
                   "masked_bwd_stat_dw2", "masked_bwd_dv", "masked_bwd_dv_dw1")
LAUNCHES = dict.fromkeys(SPILLG_LAUNCHES + MASKED_LAUNCHES, 0)

_P, _I = _build.P, _build.I
_SIGNATURES = {
    "mm_spillg_fwd_a": [_P] * 7 + [_I] * 4 + [_P] * 2,
    "mm_spillg_fwd_b": [_P] * 10 + [_I] * 4 + [_P] * 2,
    "mm_spillg_bwd_c": [_P] * 11 + [_I] * 4 + [_P] * 2,
    "mm_spillg_bwd_d": [_P] * 19 + [_I] * 4 + [_P] * 2,
    "mm_spillg_atb": [_P] * 6 + [_I] * 7 + [_P],
    "mm_tail_plan": [_I] * 5 + [_P],
    "mm_masked_rows": [_P] * 3 + [_I] * 3 + [_P],
    "mm_masked_fwd_stat": [_P] * 9 + [_I] * 4 + [_P] * 2,
    "mm_masked_fwd_apply": [_P] * 18 + [_I] * 4 + [_P] * 2,
    "mm_masked_bwd_stat": [_P] * 19 + [_I] * 4 + [_P] * 2,
    "mm_masked_bwd_dv": [_P] * 21 + [_I] * 4 + [_P] * 2,
    "mm_masked_atb": [_P] * 4 + [_I] * 6 + [_P],
}
_ATB_BLOCKS = 528  # X^T Y blocks to aim for (4 per SM on 132 SMs)
_ATB_CHUNK = 64    # rows staged per step of the X^T Y kernel
_MASKED_ATB_BLOCKS = 1584  # masked X^T Y blocks to aim for (12 of its blocks fit an SM)
ROWS_CHUNK = 4096  # rows of a chunk of the kept-row list (``CHUNK`` in csrc)


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


class BwdWeights(NamedTuple):
    """The backward's product operands, in the activation dtype (f32 on an
    f32 tail): W1 (4C, C), W1^T (C, 4C), W2^T (4C, C); contiguous copies on
    the card, views or casts in the plain version."""

    w1: torch.Tensor
    w1t: torch.Tensor
    w2t: torch.Tensor


def bwd_weights_plain(w1, w2, dtype):
    """The backward's operands for an activation ``dtype``: casts and views."""
    cd = _cd(dtype)
    return BwdWeights(w1.to(cd), w1.t().to(cd), w2.t().to(cd))


def bwd_c_plain(dy, g, nx, gamma, beta, wts, group_rows):
    """Phase C -> db2 (C,), dgamma, dbeta (4C,), dnx (G, 4C) and dW2 (C, 4C)."""
    dh = _mm(dy, wts.w2t.t(), _cd(dy.dtype))
    gf, nxr = g.float(), _per_row(nx, group_rows)
    dnx = (dh * gamma.float() * gf).reshape(-1, group_rows, gf.shape[-1]).sum(1)
    return (dy.float().sum(0), (dh * (gf * nxr)).sum(0), dh.sum(0), dnx,
            dw2_plain(dy, g, nx, gamma, beta, group_rows))


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


def _d_rows(t, dy, g_of_v, nx_rows, dgxg_rows, ln_w, ln_b, w1, b1, gamma, w2):
    """D's row pass with each row's nx and dgx/gx; ``g_of_v(v)`` is the f32 g
    of the dgx term."""
    cd = _cd(t.dtype)
    u, uhat, r = _ln(t.float(), ln_w, ln_b)
    v = _mm(u, w1.t(), cd) + b1.float()
    dh = _mm(dy, w2, cd)
    dg = dh * (gamma.float() * nx_rows + 1.0) + g_of_v(v) * dgxg_rows
    dv = dg * _gelu_grad(v)
    du = _mm(dv, w1, cd)
    da = du * ln_w.float()
    dt = r * (da - da.mean(-1, keepdim=True) - uhat * (da * uhat).mean(-1, keepdim=True))
    return dt.to(t.dtype), dv.sum(0), (du * uhat).sum(0), du.sum(0), dv.to(cd), u.to(cd)


def bwd_d_plain(t, dy, g, nx, dgxg, ln_w, ln_b, wts, b1, gamma, group_rows):
    """Phase D but dW1 -> dt (M, C) in t.dtype, db1 (4C,), dln_w, dln_b (C,),
    and dv, u rounded to the product type (dW1 = ``atb_plain(dv, u)``)."""
    return _d_rows(t, dy, lambda v: g.float(), _per_row(nx, group_rows),
                   _per_row(dgxg, group_rows), ln_w, ln_b, wts.w1, b1, gamma, wts.w2t.t())


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


def masked_fwd_stat_dense(t, keep, ln_w, ln_b, w1, b1, group_rows):
    """-> gxsq (G, 4C) f32, the sum of (g keep)^2 per group."""
    gk = _g_plain(t, ln_w, ln_b, w1, b1) * keep.float()
    return (gk * gk).reshape(-1, group_rows, gk.shape[-1]).sum(1)


def masked_fwd_apply_dense(t, x_res, keep, gxsq, ln_w, ln_b, w1, b1, gamma, beta, w2, b2,
                           group_rows):
    """-> y (M, C) in t.dtype, gx and nx (G, 4C) f32."""
    g = _g_plain(t, ln_w, ln_b, w1, b1)
    gx = torch.sqrt(gxsq)
    nx = gx / (gx.mean(-1, keepdim=True) + GRN_EPS)
    o = _mm(h_plain(g, nx, gamma, beta, group_rows), w2.t(), _cd(t.dtype)) + b2.float()
    return (x_res.float() + o * keep.float()).to(t.dtype), gx, nx


def masked_bwd_stat_dense(t, dy, keep, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, group_rows):
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


def masked_bwd_dv_dense(t, do, keep, nx, dgxg, ln_w, ln_b, w1, b1, gamma, w2, group_rows):
    """The second phase but dW1, on do: D with g keep^2 in the dgx term
    (``fused_block.py:192``) -> as ``bwd_d_plain``."""
    k = keep.float()
    return _d_rows(t, do, lambda v: _gelu(v) * k * k, _per_row(nx, group_rows),
                   _per_row(dgxg, group_rows), ln_w, ln_b, w1, b1, gamma, w2)


class KeptRows(NamedTuple):
    """The kept-row list of a keep mask: each GRN group is cut into chunks of
    ``ROWS_CHUNK`` rows (the last one shorter), and chunk q's slots (its own
    row range) hold its kept rows, ascending, then its masked ones; ``cnt``
    counts each chunk's kept rows.  Both int32, on the mask's device."""

    ids: torch.Tensor  # (M,)
    cnt: torch.Tensor  # (G * chunks a group,)


def _chunks(m, group_rows, device):
    """Each row's (or slot's) chunk and its chunk's first row."""
    r = torch.arange(m, device=device)
    grp, k = r // group_rows, (r % group_rows) // ROWS_CHUNK
    return grp * -(-group_rows // ROWS_CHUNK) + k, grp * group_rows + k * ROWS_CHUNK


def kept_rows_plain(keep, group_rows):
    """The kept-row list (``keep != 0``) of M keep values."""
    kept = keep.reshape(-1) != 0
    m = kept.numel()
    q, _ = _chunks(m, group_rows, keep.device)
    ids = torch.sort(q * 2 + (~kept).long(), stable=True).indices.to(torch.int32)
    cnt = torch.bincount(q[kept], minlength=(m // group_rows) * -(-group_rows // ROWS_CHUNK))
    return KeptRows(ids, cnt.to(torch.int32))


def kept_slots(rows, group_rows):
    """(M,) bool: the slots of the list that hold a kept row."""
    q, start = _chunks(rows.ids.numel(), group_rows, rows.ids.device)
    return torch.arange(q.numel(), device=q.device) - start < rows.cnt.long()[q]


def _kept(rows, group_rows):
    """The kept slots, the kept rows in slot order, and their groups."""
    slots = kept_slots(rows, group_rows)
    sel = rows.ids.long()[slots]
    return slots, sel, sel // group_rows


def _at_slots(rows_val, slots, dtype):
    """(M, n) in ``dtype``: ``rows_val`` at the kept slots, 0 elsewhere."""
    out = torch.zeros((slots.numel(), rows_val.shape[-1]), dtype=dtype, device=rows_val.device)
    out[slots] = rows_val.to(dtype)
    return out


def masked_fwd_stat_plain(t, keep, rows, ln_w, ln_b, w1, b1, group_rows):
    """-> gxsq (G, 4C) f32, the sum of (g keep)^2 per group over the kept rows."""
    _, sel, grp = _kept(rows, group_rows)
    gk = _g_plain(t[sel], ln_w, ln_b, w1, b1) * keep[sel].float()
    out = torch.zeros((t.shape[0] // group_rows, gk.shape[-1]), device=t.device)
    return out.index_add_(0, grp, gk * gk)


def masked_fwd_apply_plain(t, x_res, keep, rows, gxsq, ln_w, ln_b, w1, b1, gamma, beta, w2, b2,
                           group_rows):
    """-> y (M, C) in t.dtype (x_res at masked rows), gx and nx (G, 4C) f32."""
    _, sel, grp = _kept(rows, group_rows)
    gx = torch.sqrt(gxsq)
    nx = gx / (gx.mean(-1, keepdim=True) + GRN_EPS)
    g = _g_plain(t[sel], ln_w, ln_b, w1, b1)
    h = gamma.float() * (g * nx[grp]) + beta.float() + g
    o = _mm(h, w2.t(), _cd(t.dtype)) + b2.float()
    y = x_res.clone()
    y[sel] = (x_res[sel].float() + o * keep[sel].float()).to(t.dtype)
    return y, gx, nx


def masked_bwd_stat_plain(t, dy, keep, rows, nx, ln_w, ln_b, w1, b1, gamma, beta, w2,
                          group_rows):
    """The backward's first phase but dW2, on the kept rows -> db2 (C,),
    dgamma, dbeta (4C,), dnx (G, 4C), and do = dy keep and h rounded to the
    product type at the kept slots (dW2 = ``masked_atb_plain(do, h, ...)``)."""
    cd = _cd(t.dtype)
    slots, sel, grp = _kept(rows, group_rows)
    g = _g_plain(t[sel], ln_w, ln_b, w1, b1)
    do = dy[sel].float() * keep[sel].float()
    dh = _mm(do, w2, cd)
    nxr = nx[grp]
    dnx = torch.zeros_like(nx).index_add_(0, grp, dh * gamma.float() * g)
    h = gamma.float() * (g * nxr) + beta.float() + g
    return (do.sum(0), (dh * (g * nxr)).sum(0), dh.sum(0), dnx, _at_slots(do, slots, cd),
            _at_slots(h, slots, cd))


def masked_bwd_dv_plain(t, do, keep, rows, nx, dgxg, ln_w, ln_b, w1, b1, gamma, w2, group_rows):
    """The second phase but dW1, on the kept rows of do (at the slots) -> dt
    (M, C) in t.dtype (0 at masked rows), db1 (4C,), dln_w, dln_b (C,), and
    dv, u rounded to the product type at the kept slots."""
    cd = _cd(t.dtype)
    slots, sel, grp = _kept(rows, group_rows)
    k = keep[sel].float()
    dt_k, db1, dlnw, dlnb, dv, u = _d_rows(t[sel], do[slots], lambda v: _gelu(v) * k * k,
                                           nx[grp], dgxg[grp], ln_w, ln_b, w1, b1, gamma, w2)
    dt = torch.zeros_like(t)
    dt[sel] = dt_k
    return dt, db1, dlnw, dlnb, _at_slots(dv, slots, cd), _at_slots(u, slots, cd)


def masked_atb_plain(x, y, rows, group_rows):
    """x^T y over the kept slots of the list (f32 sums)."""
    slots = kept_slots(rows, group_rows)
    return atb_plain(x[slots], y[slots])


def fused_block_mlp_plain(t, x_res, keep, ln_w, ln_b, w1, b1, gamma, beta, w2, b2,
                          group_rows=None):
    """The masked forward, composed of the plain phases; params in the port's layout."""
    gr = t.shape[0] if group_rows is None else group_rows
    gm, bt = gamma.reshape(-1), beta.reshape(-1)
    rows = kept_rows_plain(keep, gr)
    gxsq = masked_fwd_stat_plain(t, keep, rows, ln_w, ln_b, w1, b1, gr)
    return masked_fwd_apply_plain(t, x_res, keep, rows, gxsq, ln_w, ln_b, w1, b1, gm, bt, w2,
                                  b2, gr)[0]


# ---------------------------------------------------------------------------
# CUDA launches (one wrapper per kernel, each counts its launch)
# ---------------------------------------------------------------------------
_LIB: list = []  # the loaded library, once built


def _lib():
    if not _LIB:
        _LIB.append(_build.library("fused_block", _SIGNATURES))
    return _LIB[0]


def _dev_call(name, key, device, *args):
    fn = getattr(_lib(), name)
    if device.index == torch.cuda.current_device():
        err = fn(*args, _build.stream_ptr(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _build.stream_ptr(device))
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
    """n f32 values, contiguous and 16-byte aligned (the kernels read them 16
    bytes at a time), on ``dev``."""
    if v.numel() != n or v.device != dev:
        raise ValueError(f"expected {n} values on {dev}, got {tuple(v.shape)} on {v.device}")
    out = v.reshape(-1).float().contiguous()
    return out if out.data_ptr() % 16 == 0 else out.clone()


def _w(w, ref, shape):
    """A weight in ``ref``'s dtype (the product type), contiguous, on its device."""
    if tuple(w.shape) != shape or w.device != ref.device:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device}, expected {shape} on "
                         f"{ref.device}")
    return w.to(ref.dtype).contiguous()


def _wt(w, ref, shape):
    """w^T in ``ref``'s dtype, contiguous, on its device: one copy."""
    if tuple(w.shape) != shape or w.device != ref.device:
        raise ValueError(f"weight {tuple(w.shape)} on {w.device}, expected {shape} on "
                         f"{ref.device}")
    return torch.empty(shape[::-1], dtype=ref.dtype, device=ref.device).copy_(w.t())


def _check_groups(x, c, group_rows, name):
    """C a multiple of 8; group_rows divides the rows."""
    m = x.shape[0]
    if c % 8:
        raise ValueError(f"{name}: C = {c} must be a multiple of 8")
    if group_rows <= 0 or m % group_rows:
        raise ValueError(f"{name}: group_rows {group_rows} must divide M = {m}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fwd_a_cuda(t, ln_w, ln_b, w1, b1, group_rows):
    """Row 7: the statistic pass on every row, storing g."""
    m, c = _rows(t, "spillg fwd A")
    _check_groups(t, c, group_rows, "spillg fwd A")
    dev, c4 = t.device, 4 * c
    g = torch.empty((m, c4), dtype=t.dtype, device=dev)
    gxsq = torch.zeros((m // group_rows, c4), dtype=torch.float32, device=dev)
    lw, lb, bb = _vec(ln_w, c, dev), _vec(ln_b, c, dev), _vec(b1, c4, dev)
    w = _w(w1, t, (c4, c))
    _, cfg, _ = _launch_of(t, "spillg_fwd_a", group_rows)
    _dev_call("mm_spillg_fwd_a", "spillg_fwd_a", dev, t.data_ptr(), lw.data_ptr(),
              lb.data_ptr(), w.data_ptr(), bb.data_ptr(), g.data_ptr(), gxsq.data_ptr(),
              m, c, group_rows, int(t.dtype == torch.bfloat16), cfg)
    return g, gxsq


def _fwd_b_cuda(g, x_res, gxsq, gamma, beta, w2, b2, group_rows):
    """Row 8: h of the stored g, y = x + h W2^T + b2, and gx, nx."""
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
    _, cfg, _ = _launch_of(x_res, "spillg_fwd_b", group_rows)
    _dev_call("mm_spillg_fwd_b", "spillg_fwd_b", dev, g.data_ptr(), x_res.data_ptr(),
              gxsq.contiguous().data_ptr(), gm.data_ptr(), bt.data_ptr(), w.data_ptr(),
              bb.data_ptr(), y.data_ptr(), gx.data_ptr(), nx.data_ptr(), m, c, group_rows,
              int(g.dtype == torch.bfloat16), cfg)
    return y, gx, nx


def _bwd_weights_cuda(w1, w2, dtype):
    """W1, W1^T and W2^T in ``dtype``, contiguous, on their device: three copies."""
    c4, c = w1.shape
    if tuple(w2.shape) != (c, c4) or w2.device != w1.device:
        raise ValueError(f"spillg weights: w1 {tuple(w1.shape)} and w2 {tuple(w2.shape)} on "
                         f"{w1.device}, {w2.device}")
    dev = w1.device
    return BwdWeights(w1.to(dtype).contiguous(),
                      torch.empty((c, c4), dtype=dtype, device=dev).copy_(w1.t()),
                      torch.empty((c4, c), dtype=dtype, device=dev).copy_(w2.t()))


def _check_weights(wts, ref, c, name):
    for a, shape in zip(wts, ((4 * c, c), (c, 4 * c), (4 * c, c))):
        _like(a, ref, shape, f"{name} weights")


def _bwd_c_cuda(dy, g, nx, gamma, beta, wts, group_rows):
    """Row 9: one launch where the plan folds dW2, else the row pass and the
    dW2 pass (``spillg_bwd_c_dw2``)."""
    m, c = _rows(dy, "spillg bwd C")
    _check_groups(dy, c, group_rows, "spillg bwd C")
    c4, dev = 4 * c, dy.device
    _like(g, dy, (m, c4), "spillg bwd C g")
    _check_weights(wts, dy, c, "spillg bwd C")
    db2, dgamma, dbeta, dnx, dw2 = _zeros(dev, c, c4, c4, (m // group_rows, c4), (c, c4))
    gm, bt = _vec(gamma, c4, dev), _vec(beta, c4, dev)
    plan, cfg, _ = _launch_of(dy, "spillg_bwd_c", group_rows)
    _dev_call("mm_spillg_bwd_c", "spillg_bwd_c", dev, dy.data_ptr(), g.data_ptr(),
              nx.contiguous().data_ptr(), gm.data_ptr(), bt.data_ptr(), wts.w2t.data_ptr(),
              db2.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), dnx.data_ptr(),
              dw2.data_ptr(), m, c, group_rows, int(dy.dtype == torch.bfloat16), cfg)
    if not plan.fold:
        _dw2_cuda(dy, g, nx, gm, bt, group_rows, out=dw2)
    return db2, dgamma, dbeta, dnx, dw2


def _atb_cuda(x, y, key, h_of=None, out=None):
    """x^T y (f32) over the rows, added to ``out`` (zeros when None); ``h_of``
    = (nx, gamma, beta, group_rows) turns y (= g) into h as it is read."""
    m, i = _rows(x, key)
    _, j = _rows(y, key)
    if y.shape[0] != m or y.dtype != x.dtype or y.device != x.device:
        raise ValueError(f"{key}: x and y must share rows, dtype and device")
    dev = x.device
    if out is None:
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


def _bwd_d_cuda(t, dy, g, nx, dgxg, ln_w, ln_b, wts, b1, gamma, group_rows):
    """The row pass of D: -> dt, db1, dln_w, dln_b, and the stored dv, u."""
    m, c = _rows(t, "spillg bwd D")
    _check_groups(t, c, group_rows, "spillg bwd D")
    c4, dev = 4 * c, t.device
    _like(dy, t, (m, c), "spillg bwd D dy")
    _like(g, t, (m, c4), "spillg bwd D g")
    _check_weights(wts, t, c, "spillg bwd D")
    dt, u = torch.empty_like(t), torch.empty_like(t)
    dv = torch.empty((m, c4), dtype=t.dtype, device=dev)
    db1, dlnw, dlnb = _zeros(dev, c4, c, c)
    _, cfg, acc = _launch_of(t, "spillg_bwd_d", group_rows)
    _dev_call("mm_spillg_bwd_d", "spillg_bwd_d", dev, t.data_ptr(), dy.data_ptr(), g.data_ptr(),
              nx.contiguous().data_ptr(), dgxg.contiguous().data_ptr(),
              _vec(ln_w, c, dev).data_ptr(), _vec(ln_b, c, dev).data_ptr(), wts.w1.data_ptr(),
              _vec(b1, c4, dev).data_ptr(), _vec(gamma, c4, dev).data_ptr(), wts.w2t.data_ptr(),
              wts.w1t.data_ptr(), dt.data_ptr(), dv.data_ptr(), u.data_ptr(), db1.data_ptr(),
              dlnw.data_ptr(), dlnb.data_ptr(), _ptr(acc), m, c, group_rows,
              int(t.dtype == torch.bfloat16), cfg)
    return dt, db1, dlnw, dlnb, dv, u


def _dw2_cuda(dy, g, nx, gamma, beta, group_rows, out=None):
    return _atb_cuda(dy, g, "spillg_bwd_c_dw2", (nx, gamma, beta, group_rows), out)


def _dw1_cuda(dv, u):
    return _atb_cuda(dv, u, "spillg_bwd_d_dw1")


def _keep_rows(keep, t, name):
    """keep as M values in t's dtype, contiguous, on t's device."""
    if keep.numel() != t.shape[0] or keep.device != t.device:
        raise ValueError(f"{name}: keep must hold one value per row ({t.shape[0]}) on "
                         f"{t.device}, got {tuple(keep.shape)} on {keep.device}")
    if keep.dtype == t.dtype and keep.is_contiguous():
        return keep
    return keep.reshape(-1).to(t.dtype).contiguous()


MASKED_KINDS = {"masked_fwd_stat": 0, "masked_fwd_apply": 1, "masked_bwd_stat": 2,
                "masked_bwd_dv": 3}
PLAN_KINDS = {**MASKED_KINDS, "spillg_bwd_c": 4, "spillg_bwd_d": 5,  # the kinds of mm_tail_plan
              "spillg_fwd_a": 6, "spillg_fwd_b": 7}
MODES = ("resident", "ring", "wide")


class TailPlan(NamedTuple):
    """A persistent pass's launch (``mm_tail_plan``): weights resident in
    shared memory (spill-g A: the block's column tiles of W1; B: its output
    rows of W2), streamed through a ring, or streamed with the C-wide row
    operands by chunk ("wide"); rows a tile; threads and shared bytes a
    block; blocks (A, B: over blockIdx.x, one wave with the split); the
    column split (the statistic passes and A: 4C's column tiles over
    blockIdx.y; B: C's output columns over blockIdx.y; spill-g C: its
    64-column slices of 4C, each taken by one or more blocks); blocks an SM;
    row tiles (masked: the list's virtual tiles); and spill-g C's dW2 fold
    (m-tiles of C a warp sums, 0: dW2 is a separate launch)."""

    mode: str
    bm: int
    threads: int
    smem: int
    blocks: int
    col_split: int
    per_sm: int
    tiles: int
    fold: int


_PLANS: dict = {}  # (device, dtype, launch, M, C, group_rows) -> (plan, int array)


def tail_plan(t, key, group_rows):
    """The plan of launch ``key`` (of ``PLAN_KINDS``) for t's shape and dtype
    on its card, and the address of its int array, made once per shape."""
    m, c = t.shape
    cache = (t.device, t.dtype, key, m, c, group_rows)
    hit = _PLANS.get(cache)
    if hit is None:
        arr = (ctypes.c_int * 9)()
        with torch.cuda.device(t.device):
            err = _lib().mm_tail_plan(PLAN_KINDS[key], m, c, group_rows,
                                      int(t.dtype == torch.bfloat16), ctypes.addressof(arr))
        _build.check(err, f"{key} plan")
        hit = _PLANS[cache] = (TailPlan(MODES[arr[0]], *arr[1:]), arr)
    return hit[0], ctypes.addressof(hit[1])


def _launch_of(t, key, group_rows):
    """(plan, its address, and the f32 C-wide scratch of a wide apply or dv
    plan, a BM x (Cp + 4) slice a block, or None)."""
    plan, ptr = tail_plan(t, key, group_rows)
    acc = None
    if plan.mode == "wide" and key in ("masked_fwd_apply", "masked_bwd_dv", "spillg_bwd_d"):
        acc = torch.empty((plan.blocks * plan.bm, -(-t.shape[1] // 16) * 16 + 4),
                          dtype=torch.float32, device=t.device)
    return plan, ptr, acc


def _check_rows(rows, t, group_rows, name):
    m = t.shape[0]
    n_cnt = (m // group_rows) * -(-group_rows // ROWS_CHUNK)
    for a, n in ((rows.ids, m), (rows.cnt, n_cnt)):
        if a.shape != (n,) or a.dtype != torch.int32 or a.device != t.device \
                or not a.is_contiguous():
            raise ValueError(f"{name}: the kept-row list must be int32 ({m},) and ({n_cnt},) "
                             f"on {t.device}")
    return rows.ids.data_ptr(), rows.cnt.data_ptr()


def _zeros(dev, *shapes):
    """f32 zeros of each shape, views of one buffer (one fill for a launch's
    atomic outputs)."""
    sizes = [math.prod(sh) if isinstance(sh, tuple) else sh for sh in shapes]
    buf = torch.zeros(sum(sizes), dtype=torch.float32, device=dev)
    out, o = [], 0
    for n, sh in zip(sizes, shapes):
        out.append(buf[o:o + n] if isinstance(sh, int) else buf[o:o + n].view(sh))
        o += n
    return out


def _masked_rows_cuda(keep, group_rows):
    """The kept-row list of keep (M values in the activation dtype)."""
    kp = keep if keep.is_contiguous() else keep.contiguous()
    m = kp.numel()
    if kp.dtype not in (torch.bfloat16, torch.float32) or not kp.is_cuda:
        raise ValueError("masked rows: keep must be bfloat16 or float32 on a CUDA device")
    if group_rows <= 0 or m % group_rows:
        raise ValueError(f"masked rows: group_rows {group_rows} must divide M = {m}")
    dev, n_cnt = kp.device, (m // group_rows) * -(-group_rows // ROWS_CHUNK)
    both = torch.empty(m + n_cnt, dtype=torch.int32, device=dev)
    ids, cnt = both[:m], both[m:]
    _dev_call("mm_masked_rows", "masked_rows", dev, kp.data_ptr(), ids.data_ptr(),
              cnt.data_ptr(), m, group_rows, int(kp.dtype == torch.bfloat16))
    return KeptRows(ids, cnt)


def _masked_fwd_stat_cuda(t, keep, rows, ln_w, ln_b, w1, b1, group_rows):
    m, c = _rows(t, "masked fwd stat")
    _check_groups(t, c, group_rows, "masked fwd stat")
    dev, c4 = t.device, 4 * c
    kp = _keep_rows(keep, t, "masked fwd stat")
    ids, cnt = _check_rows(rows, t, group_rows, "masked fwd stat")
    gxsq = torch.zeros((m // group_rows, c4), dtype=torch.float32, device=dev)
    lw, lb, bb = _vec(ln_w, c, dev), _vec(ln_b, c, dev), _vec(b1, c4, dev)
    w = _w(w1, t, (c4, c))
    _, cfg, _ = _launch_of(t, "masked_fwd_stat", group_rows)
    _dev_call("mm_masked_fwd_stat", "masked_fwd_stat", dev, t.data_ptr(), kp.data_ptr(), ids,
              cnt, lw.data_ptr(), lb.data_ptr(), w.data_ptr(), bb.data_ptr(), gxsq.data_ptr(),
              m, c, group_rows, int(t.dtype == torch.bfloat16), cfg)
    return gxsq


def _masked_fwd_apply_cuda(t, x_res, keep, rows, gxsq, ln_w, ln_b, w1, b1, gamma, beta, w2, b2,
                           group_rows):
    m, c = _rows(t, "masked fwd apply")
    _check_groups(t, c, group_rows, "masked fwd apply")
    _like(x_res, t, (m, c), "masked fwd apply x_res")
    dev, c4, n_g = t.device, 4 * c, m // group_rows
    if tuple(gxsq.shape) != (n_g, c4) or gxsq.dtype != torch.float32:
        raise ValueError("masked fwd apply: gxsq must be f32 (G, 4C)")
    kp = _keep_rows(keep, t, "masked fwd apply")
    ids, cnt = _check_rows(rows, t, group_rows, "masked fwd apply")
    y = torch.empty_like(t)
    gx, nx = torch.empty((2, n_g, c4), dtype=torch.float32, device=dev)
    w1c, w2c = _w(w1, t, (c4, c)), _w(w2, t, (c, c4))
    _, cfg, acc = _launch_of(t, "masked_fwd_apply", group_rows)
    _dev_call("mm_masked_fwd_apply", "masked_fwd_apply", dev, t.data_ptr(), x_res.data_ptr(),
              kp.data_ptr(), ids, cnt, gxsq.contiguous().data_ptr(),
              _vec(ln_w, c, dev).data_ptr(), _vec(ln_b, c, dev).data_ptr(), w1c.data_ptr(),
              _vec(b1, c4, dev).data_ptr(), _vec(gamma, c4, dev).data_ptr(),
              _vec(beta, c4, dev).data_ptr(), w2c.data_ptr(), _vec(b2, c, dev).data_ptr(),
              y.data_ptr(), gx.data_ptr(), nx.data_ptr(), _ptr(acc), m, c, group_rows,
              int(t.dtype == torch.bfloat16), cfg)
    return y, gx, nx


def _masked_bwd_stat_cuda(t, dy, keep, rows, nx, ln_w, ln_b, w1, b1, gamma, beta, w2,
                          group_rows):
    """-> db2, dgamma, dbeta, dnx and do, h at the kept slots."""
    m, c = _rows(t, "masked bwd stat")
    _check_groups(t, c, group_rows, "masked bwd stat")
    _like(dy, t, (m, c), "masked bwd stat dy")
    dev, c4 = t.device, 4 * c
    kp = _keep_rows(keep, t, "masked bwd stat")
    ids, cnt = _check_rows(rows, t, group_rows, "masked bwd stat")
    do, h = torch.empty_like(t), torch.empty((m, c4), dtype=t.dtype, device=dev)
    db2, dgamma, dbeta, dnx = _zeros(dev, c, c4, c4, (m // group_rows, c4))
    w2t = _wt(w2, t, (c, c4))
    _, cfg, _ = _launch_of(t, "masked_bwd_stat", group_rows)
    _dev_call("mm_masked_bwd_stat", "masked_bwd_stat", dev, t.data_ptr(), dy.data_ptr(),
              kp.data_ptr(), ids, cnt, nx.contiguous().data_ptr(),
              _vec(ln_w, c, dev).data_ptr(), _vec(ln_b, c, dev).data_ptr(),
              _w(w1, t, (c4, c)).data_ptr(), _vec(b1, c4, dev).data_ptr(),
              _vec(gamma, c4, dev).data_ptr(), _vec(beta, c4, dev).data_ptr(), w2t.data_ptr(),
              do.data_ptr(), h.data_ptr(), db2.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
              dnx.data_ptr(), m, c, group_rows, int(t.dtype == torch.bfloat16), cfg)
    return db2, dgamma, dbeta, dnx, do, h


def _masked_bwd_dv_cuda(t, do, keep, rows, nx, dgxg, ln_w, ln_b, w1, b1, gamma, w2, group_rows):
    """The dv pass on do at the kept slots: -> dt, db1, dln_w, dln_b, and dv,
    u at the kept slots."""
    m, c = _rows(t, "masked bwd dv")
    _check_groups(t, c, group_rows, "masked bwd dv")
    _like(do, t, (m, c), "masked bwd dv do")
    c4, dev = 4 * c, t.device
    kp = _keep_rows(keep, t, "masked bwd dv")
    ids, cnt = _check_rows(rows, t, group_rows, "masked bwd dv")
    dt, u = torch.empty_like(t), torch.empty_like(t)
    dv = torch.empty((m, c4), dtype=t.dtype, device=dev)
    db1, dlnw, dlnb = _zeros(dev, c4, c, c)
    w1c, w1t, w2t = _w(w1, t, (c4, c)), _wt(w1, t, (c4, c)), _wt(w2, t, (c, c4))
    _, cfg, acc = _launch_of(t, "masked_bwd_dv", group_rows)
    _dev_call("mm_masked_bwd_dv", "masked_bwd_dv", dev, t.data_ptr(), do.data_ptr(),
              kp.data_ptr(), ids, cnt, nx.contiguous().data_ptr(),
              dgxg.contiguous().data_ptr(), _vec(ln_w, c, dev).data_ptr(),
              _vec(ln_b, c, dev).data_ptr(), w1c.data_ptr(), _vec(b1, c4, dev).data_ptr(),
              _vec(gamma, c4, dev).data_ptr(), w2t.data_ptr(), w1t.data_ptr(), dt.data_ptr(),
              dv.data_ptr(), u.data_ptr(), db1.data_ptr(), dlnw.data_ptr(), dlnb.data_ptr(),
              _ptr(acc), m, c, group_rows, int(t.dtype == torch.bfloat16), cfg)
    return dt, db1, dlnw, dlnb, dv, u


def _masked_atb_cuda(x, y, rows, group_rows, key):
    """x^T y (f32) over the kept slots of the list."""
    m, i = _rows(x, key)
    _, j = _rows(y, key)
    if y.shape[0] != m or y.dtype != x.dtype or y.device != x.device:
        raise ValueError(f"{key}: x and y must share rows, dtype and device")
    _check_rows(rows, x, group_rows, key)
    out = torch.zeros((i, j), dtype=torch.float32, device=x.device)
    tiles = -(-i // (64 if x.dtype == torch.bfloat16 else 32)) * -(-j // 64)
    parts = max(1, min(ROWS_CHUNK // _ATB_CHUNK, _MASKED_ATB_BLOCKS // (tiles * rows.cnt.numel())))
    _dev_call("mm_masked_atb", key, x.device, x.data_ptr(), y.data_ptr(), rows.cnt.data_ptr(),
              out.data_ptr(), m, i, j, group_rows, parts, int(x.dtype == torch.bfloat16))
    return out


def _masked_dw2_cuda(do, h, rows, group_rows):
    return _masked_atb_cuda(do, h, rows, group_rows, "masked_bwd_stat_dw2")


def _masked_dw1_cuda(dv, u, rows, group_rows):
    return _masked_atb_cuda(dv, u, rows, group_rows, "masked_bwd_dv_dw1")


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------
class Phases(NamedTuple):
    """One device's phase functions, with the plain versions' signatures."""

    fwd_a: Callable
    fwd_b: Callable
    bwd_weights: Callable
    bwd_c: Callable
    bwd_d: Callable
    dw1: Callable


class MaskedPhases(NamedTuple):
    """The masked-dense tail's phase functions, with the plain versions' signatures."""

    rows: Callable
    stat: Callable
    apply: Callable
    bstat: Callable
    dw2: Callable
    dv: Callable
    dw1: Callable


PLAIN = Phases(fwd_a_plain, fwd_b_plain, bwd_weights_plain, bwd_c_plain, bwd_d_plain, atb_plain)
CUDA = Phases(_fwd_a_cuda, _fwd_b_cuda, _bwd_weights_cuda, _bwd_c_cuda, _bwd_d_cuda, _dw1_cuda)
MASKED_PLAIN = MaskedPhases(kept_rows_plain, masked_fwd_stat_plain, masked_fwd_apply_plain,
                            masked_bwd_stat_plain, masked_atb_plain, masked_bwd_dv_plain,
                            masked_atb_plain)
MASKED_CUDA = MaskedPhases(_masked_rows_cuda, _masked_fwd_stat_cuda, _masked_fwd_apply_cuda,
                           _masked_bwd_stat_cuda, _masked_dw2_cuda, _masked_bwd_dv_cuda,
                           _masked_dw1_cuda)


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
    def forward(ctx, t, x_res, ln_w, ln_b, w1, b1, gamma, beta, w2, b2, group_rows,
                process_group):
        ph = phases(t)
        gm, bt = gamma.reshape(-1), beta.reshape(-1)
        g, gxsq = ph.fwd_a(t, ln_w, ln_b, w1, b1, group_rows)
        gxsq = sum_(gxsq.contiguous(), process_group)
        y, gx, nx = ph.fwd_b(g, x_res, gxsq, gm, bt, w2, b2, group_rows)
        ctx.save_for_backward(t, g, gx, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, b2)
        ctx.group_rows, ctx.process_group = group_rows, process_group
        return y

    @staticmethod
    def backward(ctx, dy):
        t, g, gx, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, b2 = ctx.saved_tensors
        ph, gr = phases(t), ctx.group_rows
        gm, bt = gamma.reshape(-1), beta.reshape(-1)
        dy = dy.contiguous()
        wts = ph.bwd_weights(w1, w2, t.dtype)
        db2, dgamma, dbeta, dnx, dw2 = ph.bwd_c(dy, g, nx, gm, bt, wts, gr)
        dgxg = dgx_step(sum_(dnx.contiguous(), ctx.process_group), gx)
        dt, db1, dlnw, dlnb, dv, u = ph.bwd_d(t, dy, g, nx, dgxg, ln_w, ln_b, wts, b1, gm, gr)
        dw1 = ph.dw1(dv, u)
        return (dt, dy, *_param_grads((ln_w, ln_b, w1, b1, gamma, beta, w2, b2),
                                      (dlnw, dlnb, dw1, db1, dgamma, dbeta, dw2, db2)), None,
                None)


def _param_grads(params, grads):
    return [g.reshape(p.shape).to(p.dtype) for p, g in zip(params, grads)]


def _group_rows(t, group_rows, op):
    gr = t.shape[0] if group_rows is None else int(group_rows)
    if gr <= 0 or t.shape[0] % gr:
        raise ValueError(f"{op}: group_rows {gr} must divide M = {t.shape[0]}")
    return gr


class _Masked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, x_res, keep, ln_w, ln_b, w1, b1, gamma, beta, w2, b2, group_rows,
                process_group):
        ph = phases(t, masked=True)
        gm, bt = gamma.reshape(-1), beta.reshape(-1)
        rows = ph.rows(keep, group_rows)
        gxsq = sum_(ph.stat(t, keep, rows, ln_w, ln_b, w1, b1, group_rows).contiguous(),
                    process_group)
        y, gx, nx = ph.apply(t, x_res, keep, rows, gxsq, ln_w, ln_b, w1, b1, gm, bt, w2, b2,
                             group_rows)
        ctx.save_for_backward(t, keep, *rows, gx, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, b2)
        ctx.group_rows, ctx.process_group = group_rows, process_group
        return y

    @staticmethod
    def backward(ctx, dy):
        t, keep, ids, cnt, gx, nx, ln_w, ln_b, w1, b1, gamma, beta, w2, b2 = ctx.saved_tensors
        ph, gr, rows = phases(t, masked=True), ctx.group_rows, KeptRows(ids, cnt)
        gm, bt = gamma.reshape(-1), beta.reshape(-1)
        dy = dy.contiguous()
        db2, dgamma, dbeta, dnx, do, h = ph.bstat(t, dy, keep, rows, nx, ln_w, ln_b, w1, b1, gm,
                                                  bt, w2, gr)
        dw2 = ph.dw2(do, h, rows, gr)
        dgxg = dgx_step(sum_(dnx.contiguous(), ctx.process_group), gx)
        dt, db1, dlnw, dlnb, dv, u = ph.dv(t, do, keep, rows, nx, dgxg, ln_w, ln_b, w1, b1, gm,
                                           w2, gr)
        dw1 = ph.dw1(dv, u, rows, gr)
        return (dt, dy, None, *_param_grads((ln_w, ln_b, w1, b1, gamma, beta, w2, b2),
                                            (dlnw, dlnb, dw1, db1, dgamma, dbeta, dw2, db2)),
                None, None)


def fused_block_mlp(t, x_res, keep, ln_w, ln_b, w1, b1, gamma, beta, w2, b2, group_rows=None,
                    process_group=None):
    """``x_res + keep * (GRN_keep(gelu(LN(t) W1^T + b1)) W2^T + b2)`` with its
    full VJP, on the (M, C) sites of the masked dense grid.

    t, x_res: (M, C) in the activation dtype (bf16 or f32); keep: M values,
    1 = visible (its GRN statistic is over ``g * keep``; it takes no
    gradient); params as in :func:`fused_block_mlp_spillg`.  ``group_rows``:
    rows per GRN group (it must divide M); None = one group of all rows.
    ``process_group``: the ranks whose rows share each group's statistic
    (None: this process's rows alone).  On the card C must be a multiple
    of 8."""
    gr = _group_rows(t, group_rows, "fused_block_mlp")
    keep = keep.detach().reshape(t.shape[0], 1).to(t.dtype).contiguous()
    return _Masked.apply(t.contiguous(), x_res.to(t.dtype).contiguous(), keep, ln_w, ln_b, w1,
                         b1, gamma, beta, w2, b2, gr, process_group)


def fused_block_mlp_spillg(t, x_res, ln_w, ln_b, w1, b1, gamma, beta, w2, b2, group_rows=None,
                           process_group=None):
    """``x_res + GRN(gelu(LN(t) W1^T + b1)) W2^T + b2`` with its full VJP.

    t, x_res: (M, C) rows in the activation dtype (bf16 or f32); ln_w, ln_b
    (C,); w1 (4C, C) and b1 (4C,) of ``pwconv1``; gamma, beta (1, 1, 1, 4C);
    w2 (C, 4C) and b2 (C,) of ``pwconv2``; params f32.  ``group_rows``: rows
    per GRN group (it must divide M); None = one group of all rows.
    ``process_group``: the ranks whose rows share each group's statistic
    (None: this process's rows alone).  On the card C must be a multiple of
    8; rows too wide for a launch's resident shared-memory layout take its
    wide plan (``csrc/fused_block.cu``)."""
    gr = _group_rows(t, group_rows, "fused_block_mlp_spillg")
    return _SpillG.apply(t.contiguous(), x_res.to(t.dtype).contiguous(), ln_w, ln_b, w1, b1,
                         gamma, beta, w2, b2, gr, process_group)

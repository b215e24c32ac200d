#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mmearth_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: compile every CUDA source in ``mmearth_tpu_torch/csrc`` (one nvcc
   per source, in parallel) into ``build/kernels/``.
2. kernels: each kernel against its plain PyTorch version at the shapes the
   atto-56/8 batch-256 pretraining step gives it, in bf16 with TF32 off:
   gather/scatter bit-exact; dwconv7_gathered forward and dx within one bf16
   ulp (|k - p| <= 2^(floor(log2|p|) - 7) + 1e-4 * max|p|, the second term
   covering f32 summation-order noise on values near 0); dK and db within
   |k - p| <= 1e-3 * |p| + 1e-5 * max|p| (atomics reorder the sums).  Each is
   timed with CUDA events (median of 25 after warm-up) beside the plain
   version and one PyTorch call computing the same function (timed here
   only; the port never calls it).  The six spill-g launches (phases A, B, the
   row pass and the dW2 pass of C, the row pass and the dW1 pass of D) each
   against their plain phase on the same inputs at the four stage shapes:
   g, y, dt and the stored dv/u within one bf16 ulp plus 2e-3 of their scale
   (an operand of a product -- u in A, h in B -- is rounded to bf16 from an
   f32 value summed in another order, and where that rounding goes the other
   way the product moves by up to one ulp of the operand times a weight; in
   D, du also passes through LN's cancelling backward); every f32 sum (sum g^2, gx, nx, db1,
   db2, dgamma, dbeta, dnx, dLN, dW1, dW2) within 1e-3 * |p| + 1e-4 * max|p|
   (tensor-core tiles and atomics order the sums differently).  No single
   PyTorch call computes the tail, so their ``library_ms`` is the port's
   composed tail (LN -> F.linear -> GELU -> MaskedGRN -> F.linear +
   residual): its forward on A and B, its autograd backward on the four
   backward launches, labelled in ``library``.  Each bound counts the bytes
   and products of the Pallas kernel's own function; C and D are two launches
   each here, so the row pass carries the kernel's bound, the weight-gradient
   pass shows 0 with ``bound_in`` naming the row pass, and the traffic that
   the split adds (the dW2 pass re-reads dy and g; D stores dv and u and the
   dW1 pass reads them back) is given per launch as ``split_extra_bytes``.
3. slices: 1,170 samples of synthetic 64-px mmpack data, then the port's
   ``main_pretrain.main`` at convnextv2_atto 56/8, batch 256, bf16 for 12
   steps over 3 epochs, once with ``--block_impl dwg`` and once with
   ``--block_impl wholeblock``.  Every step's loss must be finite and the
   launch counters, set to 0 before each run, must rise by exactly 2/2/12/12
   (gather/scatter/dwconv fwd/bwd) per step, plus 12 of each spill-g launch
   under wholeblock and none under dwg.
4. reference: a small f32 FCMAE step on the GPU against the same step on the
   CPU (plain versions), loss and grads, for dwg and for wholeblock.

The last three lines are the card's name and power limit, one JSON object
with a row per kernel, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, GRID, K = 256, 7, 19  # atto 56/8 at batch 256, mask ratio 0.6
DW_GEOMS = ((8, 40, 2), (4, 80, 2), (2, 160, 6), (1, 320, 2))  # (p, C, blocks per step)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 25, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ulp_bound(plain, scale_frac=1e-4):
    import torch

    a = plain.float().abs()
    ulp = torch.exp2(torch.floor(torch.log2(a.clamp(min=1e-30))) - 7)
    return ulp + scale_frac * a.max()


def check_close(name, got, ref, bound) -> float:
    err = (got.float() - ref.float()).abs()
    bad = err > bound
    if bool(bad.any()):
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside the bound, "
                             f"max |err| {float(err.max()):.3e}")
    return float(err.max())


# ---------------------------------------------------------------------------
def phase_build() -> None:
    from mmearth_tpu_torch.ops import _build

    t0 = time.time()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": round(time.time() - t0, 2),
          "libraries": [str(p.relative_to(ROOT)) for p in libs]})


def phase_kernels() -> dict:
    """Kernels against their plain versions; returns one row per kernel."""
    import torch
    import torch.nn.functional as F

    from mmearth_tpu_torch.models.convnextv2 import visible_ids
    from mmearth_tpu_torch.models.fcmae import gen_random_mask
    from mmearth_tpu_torch.ops import patch_select as ps
    from mmearth_tpu_torch.ops import wholeblock as wb

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    mask = gen_random_mask(N, GRID * GRID, 0.6, gen, dev)
    kept, inv = visible_ids(mask, K)
    kept_l = kept.long()
    rows = torch.arange(N, device=dev)[:, None]
    gy, gx = kept_l // GRID, kept_l % GRID
    detail = []
    rows_out = {}

    def row(name, source, replaces):
        return rows_out.setdefault(name, {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "bound_by": "bytes", "library_ms": 0.0})

    def add(r, count, err, ms, plain, lib, bnd, by, shape):
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += count * ms
        r["plain_ms"] += count * plain
        r["library_ms"] += count * lib
        r["bound_ms"] += count * bnd
        r["bound_by"] = by
        detail.append({"kernel": r["name"], "shape": shape, "per_step": count, "ms": ms,
                       "plain_ms": plain, "library_ms": lib, "bound_ms": bnd,
                       "max_abs_err": err})

    # gather: stem gather (56x56x40 -> p=8) and the final scatter's VJP (7x7x320 -> p=1)
    g_row = row("gather_patches", "mmearth_tpu_torch/csrc/patch_select.cu",
                "mmearth_tpu/ops/patch_select.py:52")
    s_row = row("scatter_patches", "mmearth_tpu_torch/csrc/patch_select.cu",
                "mmearth_tpu/ops/patch_select.py:63")
    for p, c in ((8, 40), (1, 320)):
        h = GRID * p
        x = torch.randn(N, h, h, c, generator=gen, device=dev).to(bf)
        got = ps._gather(x, kept, p, GRID)
        ref = ps.gather_patches_plain(x, kept, p, GRID)
        if not torch.equal(got, ref):
            raise AssertionError(f"gather_patches p={p} C={c}: not bit-exact")
        x6 = x.view(N, GRID, p, GRID, p, c)
        nbytes = 2 * N * K * p * p * c * 2 + kept.numel() * 4
        add(g_row, 1, 0.0, time_ms(lambda: ps._gather(x, kept, p, GRID)),
            time_ms(lambda: ps.gather_patches_plain(x, kept, p, GRID)),
            time_ms(lambda: x6[rows, gy, :, gx]), *bound_ms(nbytes, 0, BF16_FLOPS),
            [N, h, h, c])

        xg = torch.randn(N, K, p, p, c, generator=gen, device=dev).to(bf)
        got = ps._scatter(xg, kept, inv, p, GRID, h)
        ref = ps.scatter_patches_plain(xg, kept, p, GRID, h)
        if not torch.equal(got, ref):
            raise AssertionError(f"scatter_patches p={p} C={c}: not bit-exact")

        def lib_scatter():
            out = torch.zeros(N, h, h, c, dtype=bf, device=dev)
            out.view(N, GRID, p, GRID, p, c)[rows, gy, :, gx] = xg
            return out

        if not torch.equal(lib_scatter(), ref):
            raise AssertionError("scatter library call disagrees")
        nbytes = (N * K + N * h * h // (p * p)) * p * p * c * 2 + inv.numel() * 4
        add(s_row, 1, 0.0, time_ms(lambda: ps._scatter(xg, kept, inv, p, GRID, h)),
            time_ms(lambda: ps.scatter_patches_plain(xg, kept, p, GRID, h)),
            time_ms(lib_scatter), *bound_ms(nbytes, 0, BF16_FLOPS), [N, K, p, p, c])

    f_row = row("dwconv7_gathered_fwd", "mmearth_tpu_torch/csrc/wholeblock.cu",
                "mmearth_tpu/ops/wholeblock.py:127")
    b_row = row("dwconv7_gathered_bwd", "mmearth_tpu_torch/csrc/wholeblock.cu",
                "mmearth_tpu/ops/wholeblock.py:150")
    for p, c, count in DW_GEOMS:
        h = GRID * p
        xg = torch.randn(N, K, p, p, c, generator=gen, device=dev).to(bf)
        dt = torch.randn(N, K, p, p, c, generator=gen, device=dev).to(bf)
        w = torch.randn(c, 1, 7, 7, generator=gen, device=dev)
        b = 0.1 * torch.randn(c, generator=gen, device=dev)
        got = wb._fwd_cuda(xg, kept, inv, w, b, GRID)
        ref = wb.dwconv7_gathered_plain(xg, kept, w, b, GRID)
        err = check_close(f"dwconv fwd p={p}", got, ref, ulp_bound(ref))
        dense = ps.scatter_patches_plain(xg, kept, p, GRID, h).permute(0, 3, 1, 2)
        w_bf, b_bf = w.to(bf), b.to(bf)
        elems = N * K * p * p * c
        add(f_row, count, err, time_ms(lambda: wb._fwd_cuda(xg, kept, inv, w, b, GRID)),
            time_ms(lambda: wb.dwconv7_gathered_plain(xg, kept, w, b, GRID)),
            time_ms(lambda: F.conv2d(dense, w_bf, b_bf, padding=3, groups=c)),
            *bound_ms(2 * elems * 2 + 49 * c * 4 + c * 4, 98 * elems, BF16_FLOPS),
            [N, K, p, p, c])

        dx, dk, db = wb._bwd_cuda(dt, xg, kept, inv, w, GRID)
        rdx, rdk, rdb = wb.dwconv7_gathered_bwd_plain(dt, xg, kept, w, GRID)
        err = check_close(f"dwconv dx p={p}", dx, rdx, ulp_bound(rdx))
        for nm, a, r in (("dK", dk, rdk), ("db", db, rdb)):
            rel = float(((a - r).abs() / r.abs().max()).max())
            check_close(f"dwconv {nm} p={p}", a, r, 1e-3 * r.abs() + 1e-5 * r.abs().max())
            emit({"check": f"dwconv7_gathered_bwd {nm}", "p": p, "C": c,
                  "max_err_over_max_abs": rel})
        dense_dt = ps.scatter_patches_plain(dt, kept, p, GRID, h).permute(0, 3, 1, 2)

        def lib_bwd():
            return torch.ops.aten.convolution_backward(
                dense_dt, dense, w_bf, [c], [1, 1], [3, 3], [1, 1], False, [0, 0], c,
                [True, True, True])

        add(b_row, count, err, time_ms(lambda: wb._bwd_cuda(dt, xg, kept, inv, w, GRID)),
            time_ms(lambda: wb.dwconv7_gathered_bwd_plain(dt, xg, kept, w, GRID)),
            time_ms(lib_bwd),
            *bound_ms(3 * elems * 2 + 2 * (49 * c + c) * 4, 197 * elems, BF16_FLOPS),
            [N, K, p, p, c])
    for d in detail:
        emit({"kernel_shape": d})
    return rows_out


SPILLG = (  # (LAUNCHES key, replaced Pallas kernel, library yardstick)
    ("spillg_fwd_a", "mmearth_tpu/ops/fused_block.py:381", "composed tail forward, covers A+B"),
    ("spillg_fwd_b", "mmearth_tpu/ops/fused_block.py:411", "composed tail forward, covers A+B"),
    ("spillg_bwd_c", "mmearth_tpu/ops/fused_block.py:423", "composed tail backward, covers C+D"),
    ("spillg_bwd_c_dw2", "mmearth_tpu/ops/fused_block.py:423",
     "composed tail backward, covers C+D"),
    ("spillg_bwd_d", "mmearth_tpu/ops/fused_block.py:463", "composed tail backward, covers C+D"),
    ("spillg_bwd_d_dw1", "mmearth_tpu/ops/fused_block.py:463",
     "composed tail backward, covers C+D"),
)


# the weight-gradient pass -> the row pass whose Pallas kernel's bound it shares
SPILLG_PAIR = {"spillg_bwd_c_dw2": "spillg_bwd_c", "spillg_bwd_d_dw1": "spillg_bwd_d"}


def sum_bound(ref):
    """f32 sums taken in another order: 1e-3 * |p| + 1e-4 * max|p|."""
    a = ref.float().abs()
    return 1e-3 * a + 1e-4 * a.max()


def phase_spillg_kernels() -> dict:
    """The spill-g launches against their plain phases at the four stage
    shapes (one GRN group of the batch, as ``--grn_scope per_device`` gives on
    one card); returns one row per launch."""
    import torch

    from mmearth_tpu_torch.models.convnextv2 import dense, gelu
    from mmearth_tpu_torch.models.norm import LayerNorm, MaskedGRN
    from mmearth_tpu_torch.ops import fused_block as fb

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    rows_out = {key: {"name": key, "route": "cuda",
                      "source": "mmearth_tpu_torch/csrc/fused_block.cu", "replaces": rep,
                      "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "bound_by": "bytes", "library_ms": 0.0, "library": lib,
                      "split_extra_bytes": 0}
                for key, rep, lib in SPILLG}

    def rnd(*shape, s=1.0, mean=0.0):
        return mean + s * torch.randn(*shape, generator=gen, device=dev)

    largest = {}
    for p, c, count in DW_GEOMS:
        m, c4 = N * K * p * p, 4 * c
        t, x, dy = rnd(m, c).to(bf), rnd(m, c).to(bf), rnd(m, c).to(bf)
        lw, lb, b1, b2 = rnd(c, s=0.1, mean=1.0), rnd(c, s=0.1), rnd(c4, s=0.1), rnd(c, s=0.1)
        w1, w2 = rnd(c4, c, s=c ** -0.5), rnd(c, c4, s=c4 ** -0.5)
        gm, bt = rnd(c4, s=0.5), rnd(c4, s=0.1)
        mm_flops = 2.0 * m * c * c4
        errs, every = {}, {}

        def check(key, name, got, ref, bound):
            """Holds every output; a row's max_abs_err is that of its main outputs
            (g, y, dt, dW1, dW2, C's sums), not of the sums it feeds."""
            err = check_close(f"{key} {name} C={c}", got, ref, bound)
            every[f"{key} {name}"] = err
            if name not in ("gxsq", "gx", "nx", "db1", "dln_w", "dln_b", "dv", "u"):
                errs[key] = max(errs.get(key, 0.0), err)

        # each launch on the plain outputs of the phases before it
        g, gxsq = fb._fwd_a_cuda(t, lw, lb, w1, b1, m)
        rg, rgxsq = fb.fwd_a_plain(t, lw, lb, w1, b1, m)
        check("spillg_fwd_a", "g", g, rg, ulp_bound(rg, 2e-3))
        check("spillg_fwd_a", "gxsq", gxsq, rgxsq, sum_bound(rgxsq))
        y, gx, nx = fb._fwd_b_cuda(rg, x, rgxsq, gm, bt, w2, b2, m)
        ry, rgx, rnx = fb.fwd_b_plain(rg, x, rgxsq, gm, bt, w2, b2, m)
        check("spillg_fwd_b", "y", y, ry, ulp_bound(ry, 2e-3))
        for nm, a, r in (("gx", gx, rgx), ("nx", nx, rnx)):
            check("spillg_fwd_b", nm, a, r, sum_bound(r))
        rsums = fb.bwd_c_plain(dy, rg, rnx, gm, w2, m)
        for nm, a, r in zip(("db2", "dgamma", "dbeta", "dnx"),
                            fb._bwd_c_cuda(dy, rg, rnx, gm, w2, m), rsums):
            check("spillg_bwd_c", nm, a, r, sum_bound(r))
        dw2, rdw2 = fb._dw2_cuda(dy, rg, rnx, gm, bt, m), fb.dw2_plain(dy, rg, rnx, gm, bt, m)
        check("spillg_bwd_c_dw2", "dW2", dw2, rdw2, sum_bound(rdw2))
        dgxg = fb.dgx_step(rsums[3], rgx)
        d_args = (t, dy, rg, rnx, dgxg, lw, lb, w1, b1, gm, w2, m)
        got, ref = fb._bwd_d_cuda(*d_args), fb.bwd_d_plain(*d_args)
        check("spillg_bwd_d", "dt", got[0], ref[0], ulp_bound(ref[0], 2e-3))
        for nm, a, r in zip(("db1", "dln_w", "dln_b"), got[1:4], ref[1:4]):
            check("spillg_bwd_d", nm, a, r, sum_bound(r))
        for nm, a, r in zip(("dv", "u"), got[4:], ref[4:]):
            check("spillg_bwd_d", nm, a, r, ulp_bound(r, 2e-3))
        dv, u = ref[4], ref[5]
        dw1, rdw1 = fb._dw1_cuda(dv, u), fb.atb_plain(dv, u)
        check("spillg_bwd_d_dw1", "dW1", dw1, rdw1, sum_bound(rdw1))
        emit({"check": "spillg", "C": c, "M": m, "max_abs_err": every})

        # the port's composed tail (the yardstick; the port never calls it on this path)
        norm = LayerNorm(c, dtype=bf).to(dev)
        grn = MaskedGRN(c4, bf, group=N).to(dev)
        with torch.no_grad():
            norm.weight.copy_(lw)
            norm.bias.copy_(lb)
            grn.gamma.copy_(gm.reshape(grn.gamma.shape))
            grn.beta.copy_(bt.reshape(grn.beta.shape))
        prm = [w1.clone().requires_grad_(), b1.clone().requires_grad_(),
               w2.clone().requires_grad_(), b2.clone().requires_grad_()]
        t3 = t.reshape(N, K * p * p, c).clone().requires_grad_()
        x3, dy3 = x.reshape(N, K * p * p, c), dy.reshape(N, K * p * p, c)

        def composed():
            u_ = gelu(dense(norm(t3), prm[0], prm[1], bf))
            return x3 + dense(grn(u_), prm[2], prm[3], bf)

        lib_fwd = time_ms(composed)
        y3 = composed()
        leaves = [t3, *prm, *norm.parameters(), *grn.parameters()]
        lib_bwd = time_ms(lambda: torch.autograd.grad(y3, leaves, dy3, retain_graph=True))
        del y3

        # Bytes and products of each Pallas kernel's own function: A reads t
        # and writes g; B reads g, x and writes y; C (kernel 9) reads dy, g and
        # writes dW2 (products dh, dW2); D (kernel 10) reads t, dy, g and writes
        # dt and dW1 (products v, dh, du, dW1).  The pair of launches that
        # replaces C or D shares that bound, carried on the row pass.
        rows_b, rows_4c, dw_b = m * c * 2, m * c4 * 2, c * c4 * 4
        spill = rows_b + rows_4c  # one more pass over (M, C) and (M, 4C) rows
        launches = (  # key, kernel, plain, library, bytes, products, split's extra bytes
            ("spillg_fwd_a", lambda: fb._fwd_a_cuda(t, lw, lb, w1, b1, m),
             lambda: fb.fwd_a_plain(t, lw, lb, w1, b1, m), lib_fwd,
             rows_b + rows_4c, mm_flops, 0),
            ("spillg_fwd_b", lambda: fb._fwd_b_cuda(rg, x, rgxsq, gm, bt, w2, b2, m),
             lambda: fb.fwd_b_plain(rg, x, rgxsq, gm, bt, w2, b2, m), lib_fwd,
             rows_4c + 2 * rows_b, mm_flops, 0),
            ("spillg_bwd_c", lambda: fb._bwd_c_cuda(dy, rg, rnx, gm, w2, m),
             lambda: fb.bwd_c_plain(dy, rg, rnx, gm, w2, m), lib_bwd,
             rows_b + rows_4c + dw_b, 2 * mm_flops, 0),
            ("spillg_bwd_c_dw2", lambda: fb._dw2_cuda(dy, rg, rnx, gm, bt, m),
             lambda: fb.dw2_plain(dy, rg, rnx, gm, bt, m), lib_bwd, None, None, spill),
            ("spillg_bwd_d", lambda: fb._bwd_d_cuda(*d_args), lambda: fb.bwd_d_plain(*d_args),
             lib_bwd, 3 * rows_b + rows_4c + dw_b, 4 * mm_flops, spill),
            ("spillg_bwd_d_dw1", lambda: fb._dw1_cuda(dv, u), lambda: fb.atb_plain(dv, u),
             lib_bwd, None, None, spill),
        )
        for key, kern, plain, lib, nbytes, flops, extra in launches:
            r = rows_out[key]
            ms, plain_ms = time_ms(kern), time_ms(plain)
            if nbytes is None:  # shares the bound of the row pass before it
                bnd, by, r["bound_in"] = 0.0, None, SPILLG_PAIR[key]
            else:
                bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
            r["max_abs_err"] = max(r["max_abs_err"], errs[key])
            r["ms"] += count * ms
            r["plain_ms"] += count * plain_ms
            r["library_ms"] += count * lib
            r["bound_ms"] += count * bnd
            r["split_extra_bytes"] += count * extra
            if by and count * bnd >= largest.get(key, 0.0):  # the stage that dominates
                largest[key], r["bound_by"] = count * bnd, by
            emit({"kernel_shape": {"kernel": key, "shape": [m, c], "per_step": count, "ms": ms,
                                   "plain_ms": plain_ms, "library_ms": lib, "bound_ms": bnd,
                                   "bound_by": by, "split_extra_bytes": extra,
                                   "max_abs_err": errs[key]}})
        torch.cuda.empty_cache()
    for key, pair in SPILLG_PAIR.items():
        rows_out[key]["bound_by"] = rows_out[pair]["bound_by"]
    return rows_out


def phase_data() -> Path:
    """Synthetic packed data for the slices, written anew on every run."""
    import shutil

    from mmearth_tpu_torch.data.synthetic import generate_packed

    data = ROOT / "build" / "smoke_data"
    shutil.rmtree(data, ignore_errors=True)
    t0 = time.time()
    generate_packed(data, n=1170, tile=64, seed=0)  # 1,024 train + 146 val samples
    emit({"phase": "data", "seconds": round(time.time() - t0, 2), "path": str(data)})
    return data


def phase_slice(rows_out: dict, card: str, block_impl: str, data: Path) -> dict:
    import torch

    from mmearth_tpu_torch import main_pretrain
    from mmearth_tpu_torch.ops import fused_block as fb
    from mmearth_tpu_torch.ops import patch_select as ps
    from mmearth_tpu_torch.ops import wholeblock as wb

    args = main_pretrain.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--batch_size", "256", "--use_bf16", "True", "--device", "cuda",
        "--processed_dir", str(data), "--epochs", "3", "--warmup_epochs", "1",
        "--seed", "0", "--block_impl", block_impl])
    counters = (ps.LAUNCHES, wb.LAUNCHES, fb.LAUNCHES)
    for d in counters:
        for key in d:
            d[key] = 0
    torch.cuda.reset_peak_memory_stats()
    _, history = main_pretrain.main(args)
    launches = {k: v for d in counters for k, v in d.items()}
    steps = sum(e["steps"] for e in history)
    losses = [x for e in history for x in e["step_losses"]]
    if steps < 10 or len(losses) != steps:
        raise AssertionError(f"slice ran {steps} steps")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        raise AssertionError(f"non-finite loss in {losses}")
    per_step = {"gather_patches": 2, "scatter_patches": 2,
                "dwconv7_gathered_fwd": 12, "dwconv7_gathered_bwd": 12}
    spillg = block_impl == "wholeblock"
    per_step.update({k: 12 if spillg else 0 for k in fb.LAUNCHES})
    for name, k in per_step.items():
        if launches[name] != k * steps:
            raise AssertionError(f"{block_impl} slice, {name}: {launches[name]} launches in "
                                 f"{steps} steps, expected {k} per step")
        if spillg == (name in fb.LAUNCHES):  # each kernel's count from its own path
            rows_out[name]["launches"] = launches[name]
    steady = history[1:]  # epoch 0 holds the first-call set-up
    ms = 1e3 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    result = {"phase": "slice", "block_impl": block_impl, "steps": steps,
              "epochs": len(history), "launches": launches,
              "losses": losses, "epoch_loss": [e["loss"] for e in history],
              "ms_per_step": ms, "samples_per_s": 256 * 1e3 / ms,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card}
    emit(result)
    return result


def phase_reference(block_impl: str) -> None:
    """A small f32 step on the GPU (kernels) against the CPU (plain versions)."""
    import numpy as np
    import torch

    from mmearth_tpu_torch.configs import modalities as M
    from mmearth_tpu_torch.data.synthetic import synthetic_batch
    from mmearth_tpu_torch.models.fcmae import FCMAE, gen_random_mask, zero_nan_inputs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(img_size=56, patch_size=8, depths=(2, 2, 6, 2), dims=(40, 80, 160, 320),
              grn_group=8, block_impl=block_impl, inp_modalities=M.INP_MODALITIES,
              out_modalities=M.OUT_MODALITIES)
    cpu = FCMAE(**kw).init_weights(torch.Generator().manual_seed(1))
    gpu = FCMAE(**kw).cuda()
    gpu.load_state_dict(cpu.state_dict())
    batch = zero_nan_inputs({k: torch.from_numpy(v) for k, v in
                             synthetic_batch(8, 56, seed=1).items()})
    mask = gen_random_mask(8, 49, 0.6, torch.Generator().manual_seed(2))
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        loss = model({k: v.to(dev) for k, v in batch.items()}, mask=mask.to(dev))[0]
        loss.backward()
        out[name] = (float(loss.detach()), {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                                   if p.grad is not None})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["gpu"]
    rel = abs(l_cpu - l_gpu) / abs(l_cpu)
    worst = max(float((g_gpu[k] - g_cpu[k]).abs().max() / (g_cpu[k].abs().max() + 1e-12))
                for k in g_cpu)
    # f32 on both sides; differences are summation order only
    if not (rel < 1e-4 and worst < 1e-3 and np.isfinite(l_gpu)):
        raise AssertionError(f"{block_impl} GPU vs CPU step: loss rel {rel:.2e}, "
                             f"worst grad {worst:.2e}")
    emit({"phase": "reference", "block_impl": block_impl, "loss_cpu": l_cpu, "loss_gpu": l_gpu,
          "loss_rel": rel,
          "worst_grad_rel": worst})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    phase_build()
    rows_out = phase_kernels()
    rows_out.update(phase_spillg_kernels())
    data = phase_data()
    for impl in ("dwg", "wholeblock"):
        phase_slice(rows_out, card, impl, data)
    for impl in ("dwg", "wholeblock"):
        phase_reference(impl)
    print(card, flush=True)
    emit({"kernels": list(rows_out.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

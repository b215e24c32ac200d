#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mmearth_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: compile every CUDA source in ``mmearth_tpu_torch/csrc`` (one nvcc
   per source, in parallel) into ``build/kernels/``.
2. kernels: each kernel against its plain PyTorch version at the shapes the
   atto-56/8 batch-256 pretraining step gives it, in bf16 with TF32 off:
   gather/scatter bit-exact at the stem (p = 8, C = 40) and stage 3 (p = 1,
   C = 320), and again at pico-112/16's (p = 16, C = 64 and p = 2, C = 512,
   batch 64), reported in the rows' ``pico112_stem`` and ``pico112_stage3``
   and not added to the atto step; each launch also gives its device time
   with L2 cold (``device_ms``: calls back to back on distinct inputs after
   a 128 MB write, in a window opened by a sleep kernel so that no host
   work lies inside it) beside the CUDA-event ``ms``, and its launch plan
   (path, ring, chunking, grid); dwconv7_gathered forward and dx within one bf16
   ulp (|k - p| <= 2^(floor(log2|p|) - 7) + 1e-4 * max|p|, the second term
   covering f32 summation-order noise on values near 0); dK and db within
   |k - p| <= 1e-3 * |p| + 1e-5 * max|p| (atomics reorder the sums); each
   stage's line gives the tile plan of both launches (tile in patches,
   channel chunk, threads, shared memory, 16-byte staging); p = 16 is held
   the same way at stage 0 of pico-112/16 (batch 64, C = 64), reported in
   the rows' ``pico112_stage0`` and not added to the atto step.  Each is
   timed with CUDA events (median of 25 after warm-up) beside the plain
   version and one PyTorch call computing the same function (timed here
   only; the port never calls it).  The five spill-g launches of the atto
   step (phases A, B, C with its dW2 folded in, the row pass and the dW1 pass
   of D; each stage's line gives the plans of A, B, C and D, and so do the
   pico-112/16 and C = 2816 lines) each against their plain phase on the
   same inputs at the four stage shapes:
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
   and products of the Pallas kernel's own function; D is two launches here,
   so its row pass carries the kernel's bound, the weight-gradient pass shows
   0 with ``bound_in`` naming the row pass, and the traffic that the split
   adds (D stores dv and u and the dW1 pass reads them back) is given per
   launch as ``split_extra_bytes``.  The same launches are held and timed
   at stage 3 of pico-112/16 (batch 64, C = 512), the one stage of the main
   paths where C's dW2 does not fold (C's row pass, then its separate dW2
   pass adding into the same output), reported in the rows'
   ``pico112_stage3`` and not added to the atto step.
   The seven masked-dense launches (the kept-row list; the statistic and
   apply passes of the forward; the statistic pass, its dW2 pass, the dv
   pass and its dW1 pass of the backward) each against their plain phase at
   the four masked-dense stage shapes (every site of the 56/28/14/7 grid of
   256 samples, a real mask of 19 visible patches out of 49 upsampled to
   each stage, one GRN group): the list bit-exact, the rest with the
   spill-g tolerances and their reasons, y = x and dt = 0 exactly at masked
   sites, the stored do, h, dv and u at the kept slots of the list; each
   stage's line gives the launch's plan (mode, row tile, threads, shared
   bytes, persistent blocks, column split); their yardstick is the port's
   composed masked tail.  Both tails are also held at huge's last width, C = 2816 in bf16
   (the launches whose resident layout does not fit take their wide plans),
   at 64 rows in two GRN groups and at the 4,864 rows of a batch-256 step,
   with the same tolerances, except that the dLN sums of D and of the
   masked dv pass are held against those of the launch's own stored dv,
   which must equal the plain dv in all but 5% of its elements (and A's sum
   of squares against its own stored g, as the GPU tests hold it); at
   4,864 rows each launch is timed beside its plain phase and the composed
   tail (``c2816_*`` per launch; spill-g C there is a row pass and a
   separate dW2 pass, timed together and the latter alone, ``c2816_dw2``).
   Row 5's three launches carry its bound on
   the apply pass and row 6's four on the dv pass; each bound counts what
   this run's mask needs (the products and the t, dy reads of the kept sites
   only), with the all-sites count beside it (``bound_ms_all_sites``), and
   each launch gives the bytes it moves once (``launch_bytes``).  Row 11, the dense dwconv's weight
   gradient, against its plain version in bf16 and f32 at the finetune
   step's four stage shapes, the decoder's (256, 7, 7, 512) and the four
   masked-dense stage shapes, within 1e-3 * |p| + 1e-4 * max|p| (atomics and
   tiling reorder sums of up to 8e5 terms); its yardstick is cuDNN's dW
   (``aten.convolution_backward``), its bound takes the bf16 rate for bf16
   inputs, and each shape also gives the whole conv's cost per call, port
   against PyTorch's autograd conv, on the card and on the host, and the
   kernel's launch plan.
3. slices: 1,170 samples of synthetic 64-px mmpack data, then the port's
   ``main_pretrain.main`` at convnextv2_atto 56/8, batch 256, bf16 for 12
   steps over 3 epochs, four times: the gathered encoder with
   ``--block_impl dwg`` and with ``wholeblock``, and ``--sparse_impl
   masked_dense`` with ``--block_impl auto`` (composed tail) and with
   ``fused``.  Every step's loss must be finite and the launch counters, set
   to 0 before each run, must rise by exactly 2/2/12/12 (gather/scatter/
   dwconv fwd/bwd) per step on the gathered slices and 0 on the masked-dense
   ones, 12 of each spill-g launch a step under wholeblock (C's separate
   dW2 pass none: every atto width folds it) and none elsewhere, 12 of each
   masked-dense launch a step under masked_dense
   fused (the kept-row list included) and none elsewhere, and the dense
   dwconv's dW 1 a step on the
   gathered slices (the decoder Block) and 13 on masked-dense.  Then
   292 synthetic 128-px samples and ``main_pretrain.main`` at the CLI's
   defaults, convnextv2_pico 112/16 (dwconv7_gathered at p = 16/8/4/2),
   batch 64 as bench.py's tiny112, ``--block_impl wholeblock``, 12 steps
   with the same per-step counts, but for C's separate dW2 pass, which runs
   in the 2 blocks of stage 3 (C = 512 does not fold).  The
   ``wholeblock`` slice runs with ``--output_dir build/smoke_pretrain_out``
   (wiped first, ``--save_ckpt_num 2``): its ``checkpoint-2.pth``, loaded
   into a fresh FCMAE and AdamW, must equal the run's in-memory params and
   optimizer state bit for bit; ``main_pretrain.main`` with ``--epochs 4``
   on the same directory must auto-resume after epoch 2, run epoch 3 alone
   (the slice's launches a step) and leave checkpoints 2 and 3.
   ``main_finetune.main`` runs the GEO-Bench classification recipe from
   that ``checkpoint-2.pth`` (convnextv2_atto at patch 8, batch 32, bf16, 3
   epochs of synthetic m-eurosat 512/128/128), once finetuning (12 dW
   launches a step, no other kernel) and once as the linear probe (no
   launch at all), with finite losses and accuracies in [0, 1].
4. graphs, bench and gate: 16 steps of ``pretrain_step`` run eagerly twice
   and as 2 replays of an 8-step ``train/step.py::ChainedStep`` graph from
   the same state, for atto-56/8 ``wholeblock`` and masked-dense ``fused``
   at batch 256 and pico-112/16 ``wholeblock`` at batch 64 with
   ``update_freq`` 2: the losses' largest difference from the first eager
   run, and the share of its params that differ and their median ulps, at
   most twice the second eager run's (bitwise where the two agree); the
   launches a captured step (the capture's record) and one profiled
   replay's kernels by symbol (``KERNEL_SYMBOLS``) against the slice's
   counts; eager and replay ms/step, capture seconds, peak GiB and the
   replay's idle share printed.  Then ``main_pretrain.main`` with ``--steps_per_dispatch 8`` on
   the atto ``wholeblock`` data at batch 96 (10 steps an epoch: one
   dispatch and a tail of 2 single steps), 2 epochs into
   ``build/smoke_graph_out``, then resumed for a third.  Then
   ``scripts/torch_bench.py --config atto56 --rounds 2 --steps 10`` as a
   subprocess (the built kernels reused), whose last line must carry the
   metric's keys, rates above 0 and this card; then the synthetic
   convergence gate of ``scripts/torch_convergence_gate.py`` at its full
   500 steps (batch 256, ``wholeblock``, 50-step graph replays, after its
   own bench run of 4 replays of 30 steps), whose loss must drop by more
   than half and whose samples/s must lie within 10% of its bench's, with
   the slice's launches a step on the counters (warm-ups and captures) and
   in the replays (``ChainedStep.replayed``).
5. reference: a small f32 FCMAE step on the GPU against the same step on the
   CPU (plain versions), loss and grads, for dwg, wholeblock and
   masked_dense fused, wholeblock at pico widths 112/16 (one block a
   stage), and a small f32 classifier step.

The last three lines are the card's name and power limit, one JSON object
with a row per kernel, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N, GRID, K = 256, 7, 19  # atto 56/8 at batch 256, mask ratio 0.6
DW_GEOMS = ((8, 40, 2), (4, 80, 2), (2, 160, 6), (1, 320, 2))  # (p, C, blocks per step)
DENSE_GEOMS = ((56, 40, 2), (28, 80, 2), (14, 160, 6), (7, 320, 2))  # (grid side, C, blocks)
FT_BATCH = 32  # the finetune recipe's batch
FT_GEOMS = ((64, 40, 2), (32, 80, 2), (16, 160, 6), (8, 320, 2))  # 64-px tiles at stride 1
DECODER_GEOM = (7, 512, 1)
PICO_N, PICO_P16 = 64, (16, 64, 2)  # pico 112/16 at batch 64: stage 0's (p, C, blocks)
PICO_STAGE3 = (2, 512, 2)  # and stage 3's, where spill-g C's dW2 does not fold
WIDE_C, WIDE_ROWS = 2816, 64  # huge's last stage; 64 rows in two GRN groups
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


def device_window_ms(calls, flush=None, keep: bool = True, reps: int = 5) -> float:
    """Device ms a call: the median over ``reps`` windows, each around the
    thunks ``calls`` back to back (each one's output kept to the window's
    end where ``keep``), after ``flush`` is written where given.  A sleep
    kernel opens each window, long enough for the host to enqueue every
    call first, so that no host work lies inside it; a window the host did
    not finish enqueueing within the sleep is run again with a sleep four
    times longer."""
    import torch

    cycles, times = 2_000_000, []
    while len(times) < reps:
        torch.cuda.synchronize()
        if flush is not None:
            flush.zero_()
        s0, s1, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s0.record()
        torch.cuda._sleep(cycles)
        s1.record()
        t0 = time.perf_counter()
        outs = []
        for fn in calls:
            out = fn()
            if keep:
                outs.append(out)
            del out
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        del outs
        if host >= s0.elapsed_time(s1):
            if cycles > 2 ** 34:
                raise RuntimeError("device_window_ms: the host cannot get ahead of the card")
            cycles *= 4
            continue
        times.append(s1.elapsed_time(end) / len(calls))
    return statistics.median(times)


def cold_device_ms(fn, make, in_bytes: int, reps: int = 5) -> float:
    """Device ms a call of ``fn`` with L2 cold: ``device_window_ms`` over
    calls on distinct inputs from ``make`` (over 100 MB of them, and at
    least four), each window after a 128 MB write has pushed them out of
    the 50 MB L2."""
    import math

    import torch

    copies = [make() for _ in range(max(4, math.ceil(100e6 / in_bytes)))]
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=copies[0].device)
    return device_window_ms([lambda x=x: fn(x) for x in copies], flush, True, reps)


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

    from mmearth_tpu_torch.models.convnextv2 import visible_ids
    from mmearth_tpu_torch.models.fcmae import gen_random_mask

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    mask = gen_random_mask(N, GRID * GRID, 0.6, gen, dev)
    kept, inv = visible_ids(mask, K)
    rows_out = {}

    def row(name, source, replaces):
        return rows_out.setdefault(name, {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "bound_by": "bytes", "library_ms": 0.0})

    def add(r, count, s):
        r["max_abs_err"] = max(r["max_abs_err"], s["max_abs_err"])
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "device_ms"):
            if key in s:
                r[key] += count * s[key]
        r["bound_by"] = s["bound_by"]
        emit({"kernel_shape": {"kernel": r["name"], "per_step": count, **s}})

    # gather: stem gather (56x56x40 -> p=8) and the final scatter's VJP (7x7x320 -> p=1);
    # scatter: the final scatter (p=1) and the stem gather's VJP (p=8)
    g_row = row("gather_patches", "mmearth_tpu_torch/csrc/patch_select.cu",
                "mmearth_tpu/ops/patch_select.py:52")
    s_row = row("scatter_patches", "mmearth_tpu_torch/csrc/patch_select.cu",
                "mmearth_tpu/ops/patch_select.py:63")
    for r in (g_row, s_row):
        r["device_ms"] = 0.0
    for p, c in ((8, 40), (1, 320)):
        for r, s in zip((g_row, s_row), patch_stage(gen, p, c, kept, inv)):
            add(r, 1, s)
    f_row = row("dwconv7_gathered_fwd", "mmearth_tpu_torch/csrc/wholeblock.cu",
                "mmearth_tpu/ops/wholeblock.py:127")
    b_row = row("dwconv7_gathered_bwd", "mmearth_tpu_torch/csrc/wholeblock.cu",
                "mmearth_tpu/ops/wholeblock.py:150")
    for p, c, count in DW_GEOMS:
        for r, s in zip((f_row, b_row), gathered_dwconv_stage(gen, p, c, kept, inv)):
            add(r, count, s)
    # p = 16: stage 0 of pico 112/16 at its own batch and mask, reported in
    # the rows' pico112_stage0 and not added to the atto step
    (p, c, count), pico = PICO_P16, visible_ids(
        gen_random_mask(PICO_N, GRID * GRID, 0.6, gen, dev), K)
    for r, s in zip((f_row, b_row), gathered_dwconv_stage(gen, p, c, *pico)):
        r["pico112_stage0"] = {"per_step": count, **s}
        emit({"kernel_shape": {"kernel": r["name"], "path": "pico112", "per_step": count, **s}})
    # rows 1-2 at pico 112/16's stem and stage 3 (same mask), not added to the atto step
    for (p, c), stage in (((PICO_P16[0], PICO_P16[1]), "stem"), (PICO_STAGE3[:2], "stage3")):
        for r, s in zip((g_row, s_row), patch_stage(gen, p, c, *pico)):
            r[f"pico112_{stage}"] = {"per_step": 1, **s}
            emit({"kernel_shape": {"kernel": r["name"], "path": "pico112", "per_step": 1, **s}})
    return rows_out


def patch_stage(gen, p, c, kept, inv) -> tuple[dict, dict]:
    """Rows 1-2 at one patch side: a bf16 dense (N, 7p, 7p, C) grid gathered
    at the visible ids ``kept`` and gathered rows scattered through ``inv``,
    each bit-exact against its plain version, timed beside it and one
    PyTorch indexing call (a gather, and a zero fill with an index put),
    its cold device time beside (``device_ms``); each with its launch
    plan."""
    import torch

    from mmearth_tpu_torch.ops import patch_select as ps

    dev, bf, n, h = kept.device, torch.bfloat16, kept.shape[0], GRID * p
    k = kept.shape[1]
    kept_l = kept.long()
    rows = torch.arange(n, device=dev)[:, None]
    gy, gx = kept_l // GRID, kept_l % GRID
    ids = kept.numel() * 4
    make_x = lambda: torch.randn(n, h, h, c, generator=gen, device=dev).to(bf)  # noqa: E731
    make_xg = lambda: torch.randn(n, k, p, p, c, generator=gen, device=dev).to(bf)  # noqa: E731
    x = make_x()
    got = ps._gather(x, kept, p, GRID)
    if not torch.equal(got, ps.gather_patches_plain(x, kept, p, GRID)):
        raise AssertionError(f"gather_patches p={p} C={c} N={n}: not bit-exact")
    x6 = x.view(n, GRID, p, GRID, p, c)
    gather = launch_summary(
        [n, h, h, c], 0.0, lambda: ps._gather(x, kept, p, GRID),
        lambda: ps.gather_patches_plain(x, kept, p, GRID), lambda: x6[rows, gy, :, gx],
        2 * n * k * p * p * c * 2 + ids, 0)
    gather["device_ms"] = cold_device_ms(lambda a: ps._gather(a, kept, p, GRID), make_x,
                                         n * h * h * c * 2)
    gather["plan"] = ps.launch_plan(x, kept, p, GRID, False)._asdict()

    xg = make_xg()
    ref = ps.scatter_patches_plain(xg, kept, p, GRID, h)
    if not torch.equal(ps._scatter(xg, kept, inv, p, GRID, h), ref):
        raise AssertionError(f"scatter_patches p={p} C={c} N={n}: not bit-exact")

    def lib_scatter():
        out = torch.zeros(n, h, h, c, dtype=bf, device=dev)
        out.view(n, GRID, p, GRID, p, c)[rows, gy, :, gx] = xg
        return out

    if not torch.equal(lib_scatter(), ref):
        raise AssertionError("scatter library call disagrees")
    scatter = launch_summary(
        [n, k, p, p, c], 0.0, lambda: ps._scatter(xg, kept, inv, p, GRID, h),
        lambda: ps.scatter_patches_plain(xg, kept, p, GRID, h), lib_scatter,
        (n * k + n * h * h // (p * p)) * p * p * c * 2 + inv.numel() * 4, 0)
    scatter["device_ms"] = cold_device_ms(lambda a: ps._scatter(a, kept, inv, p, GRID, h),
                                          make_xg, n * k * p * p * c * 2)
    scatter["plan"] = ps.launch_plan(xg, inv, p, GRID, True)._asdict()
    torch.cuda.empty_cache()
    return gather, scatter


def launch_summary(shape, err, kern, plain, lib, nbytes, flops) -> dict:
    """One launch at one shape: its largest error, its CUDA-event ms beside
    its plain version's and one PyTorch call's, and its bound at the bf16
    rate."""
    bnd, by = bound_ms(nbytes, flops, BF16_FLOPS)
    return {"shape": shape, "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "library_ms": time_ms(lib), "bound_ms": bnd, "bound_by": by, "max_abs_err": err}


def gathered_dwconv_stage(gen, p, c, kept, inv) -> tuple[dict, dict]:
    """Rows 3-4 at one stage: bf16 (N, K, p, p, C) patches of the visible
    ids ``kept`` (``inv`` their inverse) against the plain versions with
    phase 2's tolerances, timed beside the plain versions and cuDNN's conv
    on the scattered grid; returns the (fwd, bwd) summaries with each
    launch's tile plan."""
    import torch
    import torch.nn.functional as F

    from mmearth_tpu_torch.ops import patch_select as ps
    from mmearth_tpu_torch.ops import wholeblock as wb

    dev, bf, n, h = kept.device, torch.bfloat16, kept.shape[0], GRID * p
    xg = torch.randn(n, K, p, p, c, generator=gen, device=dev).to(bf)
    dt = torch.randn(n, K, p, p, c, generator=gen, device=dev).to(bf)
    w = torch.randn(c, 1, 7, 7, generator=gen, device=dev)
    b = 0.1 * torch.randn(c, generator=gen, device=dev)
    ref = wb.dwconv7_gathered_plain(xg, kept, w, b, GRID)
    fwd_err = check_close(f"dwconv fwd p={p}", wb._fwd_cuda(xg, kept, inv, w, b, GRID), ref,
                          ulp_bound(ref))
    dx, dk, db = wb._bwd_cuda(dt, xg, kept, inv, w, GRID)
    rdx, rdk, rdb = wb.dwconv7_gathered_bwd_plain(dt, xg, kept, w, GRID)
    bwd_err = check_close(f"dwconv dx p={p}", dx, rdx, ulp_bound(rdx))
    for nm, a, r in (("dK", dk, rdk), ("db", db, rdb)):
        check_close(f"dwconv {nm} p={p}", a, r, 1e-3 * r.abs() + 1e-5 * r.abs().max())
        emit({"check": f"dwconv7_gathered_bwd {nm}", "p": p, "C": c,
              "max_err_over_max_abs": float(((a - r).abs() / r.abs().max()).max())})
    dense = ps.scatter_patches_plain(xg, kept, p, GRID, h).permute(0, 3, 1, 2)
    dense_dt = ps.scatter_patches_plain(dt, kept, p, GRID, h).permute(0, 3, 1, 2)
    w_bf, b_bf = w.to(bf), b.to(bf)
    elems = n * K * p * p * c
    fwd = launch_summary(
        [n, K, p, p, c], fwd_err, lambda: wb._fwd_cuda(xg, kept, inv, w, b, GRID),
        lambda: wb.dwconv7_gathered_plain(xg, kept, w, b, GRID),
        lambda: F.conv2d(dense, w_bf, b_bf, padding=3, groups=c),
        2 * elems * 2 + 50 * c * 4, 98 * elems)
    bwd = launch_summary(
        [n, K, p, p, c], bwd_err, lambda: wb._bwd_cuda(dt, xg, kept, inv, w, GRID),
        lambda: wb.dwconv7_gathered_bwd_plain(dt, xg, kept, w, GRID),
        lambda: torch.ops.aten.convolution_backward(
            dense_dt, dense, w_bf, [c], [1, 1], [3, 3], [1, 1], False, [0, 0], c,
            [True, True, True]),
        3 * elems * 2 + 2 * 50 * c * 4, 197 * elems)
    fwd["plan"] = wb.launch_plan(xg, GRID, False)._asdict()
    bwd["plan"] = wb.launch_plan(xg, GRID, True)._asdict()
    return fwd, bwd


SPILLG = (  # (LAUNCHES key, replaced Pallas kernel, library yardstick) on the atto step
    ("spillg_fwd_a", "mmearth_tpu/ops/fused_block.py:381", "composed tail forward, covers A+B"),
    ("spillg_fwd_b", "mmearth_tpu/ops/fused_block.py:411", "composed tail forward, covers A+B"),
    ("spillg_bwd_c", "mmearth_tpu/ops/fused_block.py:423", "composed tail backward, covers C+D"),
    ("spillg_bwd_d", "mmearth_tpu/ops/fused_block.py:463", "composed tail backward, covers C+D"),
    ("spillg_bwd_d_dw1", "mmearth_tpu/ops/fused_block.py:463",
     "composed tail backward, covers C+D"),
)
SPILLG_WIDE_DW2 = "spillg_bwd_c_dw2"  # C's separate dW2 pass, where dW2 does not fold
# rows 7-8 run on the persistent passes; the earlier design's times stand in
# PERF.md, since the kernels line holds only this run's measurements
SPILLG_REDESIGNED = ("spillg_fwd_a", "spillg_fwd_b")


# the weight-gradient pass -> the row pass whose Pallas kernel's bound it shares
SPILLG_PAIR = {"spillg_bwd_d_dw1": "spillg_bwd_d"}


def sum_bound(ref):
    """f32 sums taken in another order: 1e-3 * |p| + 1e-4 * max|p|."""
    a = ref.float().abs()
    return 1e-3 * a + 1e-4 * a.max()


def composed_tail_ms(t, x, dy, lw, lb, w1, b1, gm, bt, w2, b2, keep=None):
    """Forward and autograd-backward ms of the port's composed block tail in
    bf16 on (N, S, C) rows (LN -> Linear -> GELU -> MaskedGRN over one group
    of N -> Linear, times ``keep`` when given, + residual): the yardstick of
    the fused tails, which the port never calls on their paths."""
    import torch

    from mmearth_tpu_torch.models.convnextv2 import dense, gelu
    from mmearth_tpu_torch.models.norm import LayerNorm, MaskedGRN

    bf, c = torch.bfloat16, t.shape[-1]
    norm = LayerNorm(c, dtype=bf).to(t.device)
    grn = MaskedGRN(4 * c, bf, group=N).to(t.device)
    with torch.no_grad():
        norm.weight.copy_(lw)
        norm.bias.copy_(lb)
        grn.gamma.copy_(gm.reshape(grn.gamma.shape))
        grn.beta.copy_(bt.reshape(grn.beta.shape))
    prm = [w1.clone().requires_grad_(), b1.clone().requires_grad_(),
           w2.clone().requires_grad_(), b2.clone().requires_grad_()]
    t3 = t.reshape(N, -1, c).clone().requires_grad_()
    x3, dy3 = x.reshape(N, -1, c), dy.reshape(N, -1, c)
    k3 = None if keep is None else keep.reshape(N, -1, 1)

    def composed():
        u_ = grn(gelu(dense(norm(t3), prm[0], prm[1], bf)), k3)
        o = dense(u_, prm[2], prm[3], bf)
        return x3 + (o if k3 is None else o * k3)

    fwd = time_ms(composed)
    y3 = composed()
    leaves = [t3, *prm, *norm.parameters(), *grn.parameters()]
    bwd = time_ms(lambda: torch.autograd.grad(y3, leaves, dy3, retain_graph=True))
    return fwd, bwd


def tail_inputs(gen, m, c) -> tuple:
    """bf16 rows t, x, dy of (m, C) and a block tail's f32 params at their
    init scale: (t, x, dy, ln_w, ln_b, w1, b1, gamma, beta, w2, b2)."""
    import torch

    dev, bf, c4 = gen.device, torch.bfloat16, 4 * c

    def rnd(*shape, s=1.0, mean=0.0):
        return mean + s * torch.randn(*shape, generator=gen, device=dev)

    t, x, dy = rnd(m, c).to(bf), rnd(m, c).to(bf), rnd(m, c).to(bf)
    lw, lb, b1, b2 = rnd(c, s=0.1, mean=1.0), rnd(c, s=0.1), rnd(c4, s=0.1), rnd(c, s=0.1)
    w1, w2 = rnd(c4, c, s=c ** -0.5), rnd(c, c4, s=c4 ** -0.5)
    gm, bt = rnd(c4, s=0.5), rnd(c4, s=0.1)
    return t, x, dy, lw, lb, w1, b1, gm, bt, w2, b2


def spillg_parity(check, inputs, gr, wide=False) -> dict:
    """Each spill-g launch on ``inputs`` (:func:`tail_inputs`) in GRN groups
    of ``gr`` rows, on the plain outputs of the phases before it, held by
    ``check(key, name, got, ref, bound)`` against its plain phase: g, y, dt,
    dv, u within one bf16 ulp plus 2e-3 of their scale, every f32 sum within
    :func:`sum_bound`; C's dW2 from its one launch, or where it does not fold
    from its separate pass (also held and timed alone).  ``wide`` (huge's C =
    2816, where D takes its wide plan): A's sum of squares is held against
    that of its own stored g, and dLN's two sums as :func:`dln_reference`
    says.  Returns {launch: (kernel, plain)} to time."""
    from mmearth_tpu_torch.ops import fused_block as fb

    t, x, dy, lw, lb, w1, b1, gm, bt, w2, b2 = inputs
    c, c4 = t.shape[1], w1.shape[0]
    wts, rwts = fb._bwd_weights_cuda(w1, w2, t.dtype), fb.bwd_weights_plain(w1, w2, t.dtype)
    fold = fb.tail_plan(t, "spillg_bwd_c", gr)[0].fold > 0
    g, gxsq = fb._fwd_a_cuda(t, lw, lb, w1, b1, gr)
    rg, rgxsq = fb.fwd_a_plain(t, lw, lb, w1, b1, gr)
    check("spillg_fwd_a", "g", g, rg, ulp_bound(rg, 2e-3))
    own = (g.float() ** 2).reshape(-1, gr, c4).sum(1) if wide else rgxsq
    check("spillg_fwd_a", "gxsq", gxsq, own, sum_bound(own))
    b_args = (rg, x, rgxsq, gm, bt, w2, b2, gr)
    got, (ry, rgx, rnx) = fb._fwd_b_cuda(*b_args), fb.fwd_b_plain(*b_args)
    check("spillg_fwd_b", "y", got[0], ry, ulp_bound(ry, 2e-3))
    for nm, a, r in zip(("gx", "nx"), got[1:], (rgx, rnx)):
        check("spillg_fwd_b", nm, a, r, sum_bound(r))
    c_args, rc_args = (dy, rg, rnx, gm, bt, wts, gr), (dy, rg, rnx, gm, bt, rwts, gr)
    rsums = fb.bwd_c_plain(*rc_args)
    for nm, a, r in zip(("db2", "dgamma", "dbeta", "dnx", "dW2"), fb._bwd_c_cuda(*c_args), rsums):
        check("spillg_bwd_c", nm, a, r, sum_bound(r))
    if not fold:
        check(SPILLG_WIDE_DW2, "dW2", fb._dw2_cuda(dy, rg, rnx, gm, bt, gr), rsums[4],
              sum_bound(rsums[4]))
    dgxg = fb.dgx_step(rsums[3], rgx)
    d_args, rd_args = ((t, dy, rg, rnx, dgxg, lw, lb, ws, b1, gm, gr) for ws in (wts, rwts))
    got, ref = fb._bwd_d_cuda(*d_args), fb.bwd_d_plain(*rd_args)
    check("spillg_bwd_d", "dt", got[0], ref[0], ulp_bound(ref[0], 2e-3))
    dln = dln_reference("spillg_bwd_d", t, got[4], ref[4], got[2:4], ref[2:4], w1, lw, lb, wide)
    for nm, a, r in zip(("db1", "dln_w", "dln_b"), got[1:4], (ref[1], *dln)):
        check("spillg_bwd_d", nm, a, r, sum_bound(r))
    for nm, a, r in zip(("dv", "u"), got[4:], ref[4:]):
        check("spillg_bwd_d", nm, a, r, ulp_bound(r, 2e-3))
    dv, u = ref[4], ref[5]
    rdw1 = fb.atb_plain(dv, u)
    check("spillg_bwd_d_dw1", "dW1", fb._dw1_cuda(dv, u), rdw1, sum_bound(rdw1))
    launches = {
        "spillg_fwd_a": (lambda: fb._fwd_a_cuda(t, lw, lb, w1, b1, gr),
                         lambda: fb.fwd_a_plain(t, lw, lb, w1, b1, gr)),
        "spillg_fwd_b": (lambda: fb._fwd_b_cuda(*b_args), lambda: fb.fwd_b_plain(*b_args)),
        "spillg_bwd_c": (lambda: fb._bwd_c_cuda(*c_args), lambda: fb.bwd_c_plain(*rc_args)),
        "spillg_bwd_d": (lambda: fb._bwd_d_cuda(*d_args), lambda: fb.bwd_d_plain(*rd_args)),
        "spillg_bwd_d_dw1": (lambda: fb._dw1_cuda(dv, u), lambda: fb.atb_plain(dv, u)),
    }
    if not fold:
        launches[SPILLG_WIDE_DW2] = (lambda: fb._dw2_cuda(dy, rg, rnx, gm, bt, gr),
                                     lambda: fb.dw2_plain(dy, rg, rnx, gm, bt, gr))
    return launches


def dln_reference(key, t, dv, ref_dv, got, ref, w1, ln_w, ln_b, wide):
    """The reference of a dv pass's two dLN sums (``got``/``ref``: the
    launch's and the plain phase's sums; ``dv``/``ref_dv``: their stored dv,
    row for row with ``t``): the plain phase's sums, or where ``wide`` (C =
    2816) those of the launch's own stored dv through the plain du = dv W1,
    with that dv equal to the plain dv in all but 5% of its elements (a dv
    rounding one ulp the other way moves an 11,264-term du past the f32
    bound).  Emits the flipped share and the plain sums' worst error over
    their bound, which is not held."""
    from mmearth_tpu_torch.ops import fused_block as fb

    if not wide:
        return ref
    m, c = t.shape
    flips = float((dv != ref_dv).float().mean())
    if flips >= 0.05:
        raise AssertionError(f"{key} C={c}: dv differs from the plain dv in {flips:.1%} of its "
                             "elements")
    _, uhat, _ = fb._ln(t.float(), ln_w, ln_b)
    du = dv.float() @ w1.to(dv.dtype).float()
    own = (du * uhat).sum(0), du.sum(0)
    vs_plain = max(float(((a - r).abs() / sum_bound(r)).max()) for a, r in zip(got, ref))
    emit({"check": f"{key} dLN", "C": c, "M": m, "dv_flipped_fraction": flips,
          "plain_err_over_bound": vs_plain})
    return own


def phase_spillg_kernels() -> dict:
    """The spill-g launches against their plain phases at the four stage
    shapes (one GRN group of the batch, as ``--grn_scope per_device`` gives on
    one card), then at C = 2816 (:func:`wide_tail_check`); returns one row
    per launch."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows_out = {key: {"name": key, "route": "cuda",
                      "source": "mmearth_tpu_torch/csrc/fused_block.cu", "replaces": rep,
                      "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "bound_by": "bytes", "library_ms": 0.0, "library": lib,
                      "split_extra_bytes": 0}
                for key, rep, lib in SPILLG}
    for key in SPILLG_REDESIGNED:
        rows_out[key].update(redesigned=True, earlier_design_ms="PERF.md section 6, rows 7-8")
    # a row's max_abs_err is that of its main outputs (g, y, dt, dW1, dW2, C's
    # sums), not of the sums it feeds
    side = ("gxsq", "gx", "nx", "db1", "dln_w", "dln_b", "dv", "u")

    largest = {}
    for p, c, count in DW_GEOMS:
        m, c4 = N * K * p * p, 4 * c
        inputs = tail_inputs(gen, m, c)
        errs, every = {}, {}

        def check(key, name, got, ref, bound):
            err = check_close(f"{key} {name} C={c}", got, ref, bound)
            every[f"{key} {name}"] = err
            if name not in side:
                errs[key] = max(errs.get(key, 0.0), err)

        launches = spillg_parity(check, inputs, m)
        if SPILLG_WIDE_DW2 in launches:
            raise AssertionError(f"spillg_bwd_c C={c}: dW2 does not fold at an atto width")
        emit({"check": "spillg", "C": c, "M": m, "max_abs_err": every})
        lib_fwd, lib_bwd = composed_tail_ms(*inputs)

        bounds = spillg_bounds(m, c, lib_fwd, lib_bwd)
        for key, (kern, plain) in launches.items():
            lib, nbytes, flops, extra = bounds[key]
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
            plan = plan_of(inputs[0], key, m)
            if plan is not None:
                r.setdefault("plans", {})[f"C={c}"] = plan
            emit({"kernel_shape": {"kernel": key, "shape": [m, c], "per_step": count, "ms": ms,
                                   "plain_ms": plain_ms, "library_ms": lib, "bound_ms": bnd,
                                   "bound_by": by, "split_extra_bytes": extra, "plan": plan,
                                   "max_abs_err": errs[key]}})
        del launches, inputs
        torch.cuda.empty_cache()
    for key, pair in SPILLG_PAIR.items():
        rows_out[key]["bound_by"] = rows_out[pair]["bound_by"]
    pico_stage3_check(rows_out, gen, side)
    wide_tail_check(rows_out, gen, spillg_parity)
    return rows_out


def spillg_bounds(m, c, lib_fwd, lib_bwd) -> dict:
    """Per spill-g launch at (m, C): (library ms, bytes, products, the split's
    extra bytes).  Bytes and products of each Pallas kernel's own function: A
    reads t and writes g; B reads g, x and writes y; C (kernel 9) reads dy, g
    and writes dW2 (products dh, dW2); D (kernel 10) reads t, dy, g and
    writes dt and dW1 (products v, dh, du, dW1).  The pair of launches that
    replaces D shares that bound, carried on the row pass; C's separate dW2
    pass, where dW2 does not fold, shares C's."""
    c4 = 4 * c
    rows_b, rows_4c, dw_b = m * c * 2, m * c4 * 2, c * c4 * 4
    mm_flops = 2.0 * m * c * c4
    spill = rows_b + rows_4c  # one more pass over (M, C) and (M, 4C) rows
    return {
        "spillg_fwd_a": (lib_fwd, rows_b + rows_4c, mm_flops, 0),
        "spillg_fwd_b": (lib_fwd, rows_4c + 2 * rows_b, mm_flops, 0),
        "spillg_bwd_c": (lib_bwd, rows_b + rows_4c + dw_b, 2 * mm_flops, 0),
        SPILLG_WIDE_DW2: (lib_bwd, None, None, 0),
        "spillg_bwd_d": (lib_bwd, 3 * rows_b + rows_4c + dw_b, 4 * mm_flops, spill),
        "spillg_bwd_d_dw1": (lib_bwd, None, None, spill),
    }


def pico_stage3_check(rows_out, gen, side) -> None:
    """The spill-g launches at stage 3 of pico 112/16 (batch 64, C = 512, one
    GRN group), the one stage of the main paths where C's dW2 does not fold:
    C runs its row pass and the separate dW2 pass, which adds into C's zeroed
    output.  Each launch against its plain phase with the atto stages'
    tolerances, timed beside it, in the rows' ``pico112_stage3`` (C's also
    gives the dW2 pass alone, ``dw2``, and both together, ``with_dw2_ms``);
    not added to the atto step."""
    import torch

    p, c, count = PICO_STAGE3
    m = PICO_N * K * p * p
    errs, every = {}, {}

    def check(key, name, got, ref, bound):
        err = check_close(f"{key} {name} C={c} pico112", got, ref, bound)
        every[f"{key} {name}"] = err
        if name not in side:
            errs[key] = max(errs.get(key, 0.0), err)

    inputs = tail_inputs(gen, m, c)
    launches = spillg_parity(check, inputs, m)
    if SPILLG_WIDE_DW2 not in launches:
        raise AssertionError(f"spillg_bwd_c C={c}: expected the separate dW2 pass")
    emit({"check": "spillg", "path": "pico112", "C": c, "M": m, "max_abs_err": every})
    bounds = spillg_bounds(m, c, None, None)
    for key, (kern, plain) in launches.items():
        _, nbytes, flops, _ = bounds[key]
        bnd, by = bound_ms(nbytes, flops, BF16_FLOPS) if nbytes else (0.0, None)
        s = {"per_step": count, "shape": [m, c], "ms": time_ms(kern), "plain_ms": time_ms(plain),
             "bound_ms": bnd, "bound_by": by, "max_abs_err": errs[key],
             "plan": plan_of(inputs[0], key, m)}
        if key == SPILLG_WIDE_DW2:
            entry = rows_out["spillg_bwd_c"]["pico112_stage3"]
            entry["dw2"] = s
            entry["with_dw2_ms"] = entry["ms"] + s["ms"]
            entry["with_dw2_plain_ms"] = entry["plain_ms"] + s["plain_ms"]
        else:
            rows_out[key]["pico112_stage3"] = s
        emit({"kernel_shape": {"kernel": key, "path": "pico112", **s}})
    del launches, inputs
    torch.cuda.empty_cache()


def wide_tail_check(rows_out, gen, parity) -> None:
    """Every launch of a tail (``parity``: :func:`spillg_parity` or
    :func:`masked_parity`, about 40% of the rows kept) at huge's last width,
    C = 2816 in bf16, where the launches whose resident layout does not fit
    take their wide plans, against its plain phase: at WIDE_ROWS rows in two
    GRN groups, then at huge's last stage of a batch-256 step at 56/8 or
    112/16 (N x K rows, one group), where each launch is also timed beside
    its plain phase and the composed tail.  Each launch's row gets
    ``c2816_max_abs_err`` (over both), ``c2816_ms``, ``c2816_plain_ms`` and
    ``c2816_library_ms`` (the composed tail's forward or backward)."""
    import torch

    errs = {}

    def check(key, name, got, ref, bound):
        err = check_close(f"{key} {name} C={WIDE_C}", got, ref, bound)
        errs[key] = max(errs.get(key, 0.0), err)

    for m, gr in ((WIDE_ROWS, WIDE_ROWS // 2), (N * K, N * K)):
        inputs = tail_inputs(gen, m, WIDE_C)
        extra = {}
        if parity is masked_parity:
            extra["keep"] = (torch.rand(m, 1, generator=gen, device=gen.device) > 0.6).to(
                torch.bfloat16)
        launches = parity(check, inputs, gr, wide=True, **extra)
    lib_fwd, lib_bwd = composed_tail_ms(*inputs, extra.get("keep"))
    for key, (kern, plain) in launches.items():
        if key == SPILLG_WIDE_DW2:  # C's separate dW2 pass, alone
            rows_out["spillg_bwd_c"]["c2816_dw2"] = {
                "max_abs_err": errs[key], "ms": time_ms(kern), "plain_ms": time_ms(plain)}
            continue
        rows_out[key].update({"c2816_max_abs_err": errs[key], "c2816_ms": time_ms(kern),
                              "c2816_plain_ms": time_ms(plain),
                              "c2816_library_ms": lib_bwd if "_bwd_" in key else lib_fwd,
                              "c2816_plan": plan_of(inputs[0], key, N * K)})
    emit({"check": "wide_tail", "C": WIDE_C, "M": [WIDE_ROWS, N * K],
          "launches": {key: {k[6:]: v for k, v in rows_out[key].items() if k.startswith("c2816_")}
                       for key in launches if key in rows_out}})
    del launches, inputs
    torch.cuda.empty_cache()


MASKED = (  # (LAUNCHES key, replaced Pallas kernel, library yardstick)
    ("masked_rows", "mmearth_tpu/ops/fused_block.py:87",
     "composed masked tail forward, covers both forward passes"),
    ("masked_fwd_stat", "mmearth_tpu/ops/fused_block.py:87",
     "composed masked tail forward, covers both forward passes"),
    ("masked_fwd_apply", "mmearth_tpu/ops/fused_block.py:87",
     "composed masked tail forward, covers both forward passes"),
    ("masked_bwd_stat", "mmearth_tpu/ops/fused_block.py:129",
     "composed masked tail backward, covers the four backward launches"),
    ("masked_bwd_stat_dw2", "mmearth_tpu/ops/fused_block.py:129",
     "composed masked tail backward, covers the four backward launches"),
    ("masked_bwd_dv", "mmearth_tpu/ops/fused_block.py:129",
     "composed masked tail backward, covers the four backward launches"),
    ("masked_bwd_dv_dw1", "mmearth_tpu/ops/fused_block.py:129",
     "composed masked tail backward, covers the four backward launches"),
)
# the launch that carries the bound of the Pallas kernel it shares
MASKED_CARRIER = {"masked_rows": "masked_fwd_apply", "masked_fwd_stat": "masked_fwd_apply",
                  "masked_bwd_stat": "masked_bwd_dv",
                  "masked_bwd_stat_dw2": "masked_bwd_dv", "masked_bwd_dv_dw1": "masked_bwd_dv"}


def masked_parity(check, inputs, gr, keep, wide=False) -> dict:
    """Each masked-dense launch on ``inputs`` (:func:`tail_inputs`) with the
    sites ``keep`` (M, 1) kept, in GRN groups of ``gr`` rows, on the plain
    outputs of the phases before it, held by ``check`` against its plain
    phase with the spill-g tolerances (``wide``: dLN's two sums as
    :func:`dln_reference` says): the kept-row list bit-exact; y, dt and every
    sum in full, with y = x and dt = 0 exactly at masked sites; the stored
    do (bit-exact), h, dv and u at the kept slots of the list.  Returns
    {launch: (kernel, plain)} to time."""
    import torch

    from mmearth_tpu_torch.ops import fused_block as fb

    t, x, dy, lw, lb, w1, b1, gm, bt, w2, b2 = inputs
    c = t.shape[1]
    masked = keep[:, 0] == 0
    rows, rrows = fb._masked_rows_cuda(keep, gr), fb.kept_rows_plain(keep, gr)
    if not (torch.equal(rows.ids, rrows.ids) and torch.equal(rows.cnt, rrows.cnt)):
        raise AssertionError(f"masked_rows C={c}: the kept-row list differs from the plain one")
    check("masked_rows", "list", rows.ids.float(), rrows.ids.float(), 0.0)
    slots = fb.kept_slots(rrows, gr)
    sel = rrows.ids.long()[slots]
    gxsq = fb._masked_fwd_stat_cuda(t, keep, rows, lw, lb, w1, b1, gr)
    rgxsq = fb.masked_fwd_stat_plain(t, keep, rrows, lw, lb, w1, b1, gr)
    check("masked_fwd_stat", "gxsq", gxsq, rgxsq, sum_bound(rgxsq))
    ap_args = (t, x, keep, rows, rgxsq, lw, lb, w1, b1, gm, bt, w2, b2, gr)
    y, gx, nx = fb._masked_fwd_apply_cuda(*ap_args)
    ry, rgx, rnx = fb.masked_fwd_apply_plain(*ap_args)
    check("masked_fwd_apply", "y", y, ry, ulp_bound(ry, 2e-3))
    if not torch.equal(y[masked], x[masked]):
        raise AssertionError(f"masked_fwd_apply C={c}: y != x at a masked site")
    for nm, a, r in (("gx", gx, rgx), ("nx", nx, rnx)):
        check("masked_fwd_apply", nm, a, r, sum_bound(r))
    st_args = (t, dy, keep, rows, rnx, lw, lb, w1, b1, gm, bt, w2, gr)
    got, ref = fb._masked_bwd_stat_cuda(*st_args), fb.masked_bwd_stat_plain(*st_args)
    for nm, a, r in zip(("db2", "dgamma", "dbeta", "dnx"), got[:4], ref[:4]):
        check("masked_bwd_stat", nm, a, r, sum_bound(r))
    if not torch.equal(got[4][slots], ref[4][slots]):
        raise AssertionError(f"masked_bwd_stat C={c}: do = dy * keep not bit-exact")
    check("masked_bwd_stat", "h", got[5][slots], ref[5][slots], ulp_bound(ref[5][slots], 2e-3))
    do, hh = ref[4], ref[5]
    rdw2 = fb.masked_atb_plain(do, hh, rrows, gr)
    check("masked_bwd_stat_dw2", "dW2", fb._masked_dw2_cuda(do, hh, rows, gr), rdw2,
          sum_bound(rdw2))
    dv_args = (t, do, keep, rows, rnx, fb.dgx_step(ref[3], rgx), lw, lb, w1, b1, gm, w2, gr)
    got, ref = fb._masked_bwd_dv_cuda(*dv_args), fb.masked_bwd_dv_plain(*dv_args)
    check("masked_bwd_dv", "dt", got[0], ref[0], ulp_bound(ref[0], 2e-3))
    if bool(got[0][masked].any()):
        raise AssertionError(f"masked_bwd_dv C={c}: dt != 0 at a masked site")
    dln = dln_reference("masked_bwd_dv", t[sel], got[4][slots], ref[4][slots], got[2:4],
                        ref[2:4], w1, lw, lb, wide)
    for nm, a, r in zip(("db1", "dln_w", "dln_b"), got[1:4], (ref[1], *dln)):
        check("masked_bwd_dv", nm, a, r, sum_bound(r))
    for nm, a, r in zip(("dv", "u"), got[4:], ref[4:]):
        check("masked_bwd_dv", nm, a[slots], r[slots], ulp_bound(r[slots], 2e-3))
    dv, u = ref[4], ref[5]
    rdw1 = fb.masked_atb_plain(dv, u, rrows, gr)
    check("masked_bwd_dv_dw1", "dW1", fb._masked_dw1_cuda(dv, u, rows, gr), rdw1,
          sum_bound(rdw1))
    return {
        "masked_rows": (lambda: fb._masked_rows_cuda(keep, gr),
                        lambda: fb.kept_rows_plain(keep, gr)),
        "masked_fwd_stat": (lambda: fb._masked_fwd_stat_cuda(t, keep, rows, lw, lb, w1, b1, gr),
                            lambda: fb.masked_fwd_stat_plain(t, keep, rrows, lw, lb, w1, b1,
                                                             gr)),
        "masked_fwd_apply": (lambda: fb._masked_fwd_apply_cuda(*ap_args),
                             lambda: fb.masked_fwd_apply_plain(*ap_args)),
        "masked_bwd_stat": (lambda: fb._masked_bwd_stat_cuda(*st_args),
                            lambda: fb.masked_bwd_stat_plain(*st_args)),
        "masked_bwd_stat_dw2": (lambda: fb._masked_dw2_cuda(do, hh, rows, gr),
                                lambda: fb.masked_atb_plain(do, hh, rrows, gr)),
        "masked_bwd_dv": (lambda: fb._masked_bwd_dv_cuda(*dv_args),
                          lambda: fb.masked_bwd_dv_plain(*dv_args)),
        "masked_bwd_dv_dw1": (lambda: fb._masked_dw1_cuda(dv, u, rows, gr),
                              lambda: fb.masked_atb_plain(dv, u, rrows, gr)),
    }


def plan_of(t, key, group_rows):
    """A persistent launch's plan at t's shape (its mode, row tile, threads,
    shared bytes, blocks, column split, and spill-g C's dW2 fold), or None
    for the launches without one (the list and the X^T Y passes)."""
    from mmearth_tpu_torch.ops import fused_block as fb

    if key not in fb.PLAN_KINDS:
        return None
    plan = fb.tail_plan(t, key, group_rows)[0]
    return {k: getattr(plan, k) for k in ("mode", "bm", "threads", "smem", "blocks",
                                          "col_split", "fold")}


def phase_masked_kernels() -> dict:
    """The masked-dense launches against their plain phases at the four
    masked-dense stage shapes (every site of each stage's grid, a mask of K
    visible patches upsampled to it, one GRN group of the batch), then at C
    = 2816 with about 40% of the rows kept (:func:`wide_tail_check`);
    returns one row per launch."""
    import torch

    from mmearth_tpu_torch.models.convnextv2 import upsample_mask
    from mmearth_tpu_torch.models.fcmae import gen_random_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(2)
    keep_flat = 1.0 - gen_random_mask(N, GRID * GRID, 0.6, gen, dev)
    rows_out = {key: {"name": key, "route": "cuda",
                      "source": "mmearth_tpu_torch/csrc/fused_block.cu", "replaces": rep,
                      "launches": 0, "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                      "bound_ms": 0.0, "bound_by": "bytes", "library_ms": 0.0, "library": lib,
                      "bound_ms_all_sites": 0.0, "launch_bytes": 0, "max_err_over_scale": 0.0}
                for key, rep, lib in MASKED}
    # a row's max_abs_err (and max_err_over_scale, the error over the
    # output's largest magnitude) is that of its main outputs (y, dt, dW1,
    # dW2, the statistic passes' sums), not of those it feeds
    side = ("gx", "nx", "h", "db1", "dln_w", "dln_b", "dv", "u")

    largest = {}
    for h, c, count in DENSE_GEOMS:
        m, c4 = N * h * h, 4 * c
        keep = upsample_mask(keep_flat, GRID, h).reshape(m, 1).to(bf)
        kept = int(keep.float().sum())
        inputs = tail_inputs(gen, m, c)
        errs, rel, every = {}, {}, {}

        def check(key, name, got, ref, bound):
            err = check_close(f"{key} {name} C={c}", got, ref, bound)
            every[f"{key} {name}"] = err
            if name not in side:
                errs[key] = max(errs.get(key, 0.0), err)
                rel[key] = max(rel.get(key, 0.0), err / float(ref.float().abs().max()))

        launches = masked_parity(check, inputs, m, keep)
        emit({"check": "masked", "C": c, "M": m, "kept_sites": kept, "max_abs_err": every})
        lib_fwd, lib_bwd = composed_tail_ms(*inputs, keep)

        # Bytes and products of each Pallas kernel's own function, for this
        # run's mask: the forward (kernel 5) reads keep, t at the kept sites
        # (only they reach y), x, and writes y, with 2 products over the kept
        # sites; the backward (kernel 6) reads keep, t and dy at the kept
        # sites, writes dt, and the param grads, with 5 products (v, dh, dW2,
        # du, dW1).  Params and their grads f32.  ``_all`` counts every site,
        # as the Pallas kernel computes them.
        rows_b, keep_b, par_b = m * c * 2, m * 2, (2 * c * c4 + 2 * c + 3 * c4 + c) * 4
        mm = 2.0 * c * c4  # flops a site of one product
        # (bytes, flops) for the kept sites, then for every site
        fwd = [(keep_b + 2 * rows_b + s * c * 2 + par_b, 2 * mm * s) for s in (kept, m)]
        bwd = [(keep_b + rows_b + 2 * s * c * 2 + 2 * par_b, 5 * mm * s) for s in (kept, m)]
        # what each launch itself moves once (weights and the list's counts
        # left out): a kept row's (C) and (4C) values, its id and keep
        kc_b, k4_b, kid_b, dwb = kept * c * 2, kept * c4 * 2, kept * 6, c * c4 * 4
        bounds = {  # library, bytes the launch moves, own bound (or None)
            "masked_rows": (lib_fwd, keep_b + m * 4, None),
            "masked_fwd_stat": (lib_fwd, kc_b + kid_b, None),
            "masked_fwd_apply": (lib_fwd, kc_b + 2 * rows_b + m * 4 + 2 * kept, fwd),
            "masked_bwd_stat": (lib_bwd, 3 * kc_b + k4_b + kid_b, None),
            "masked_bwd_stat_dw2": (lib_bwd, kc_b + k4_b + dwb, None),
            "masked_bwd_dv": (lib_bwd, 3 * kc_b + rows_b + k4_b + m * 4 + 2 * kept, bwd),
            "masked_bwd_dv_dw1": (lib_bwd, kc_b + k4_b + dwb, None),
        }
        for key, (kern, plain) in launches.items():
            lib, moved, bnd_of = bounds[key]
            r = rows_out[key]
            ms, plain_ms = time_ms(kern), time_ms(plain)
            if bnd_of is None:  # shares the bound of the launch that carries it
                bnd, by, bnd_all, r["bound_in"] = 0.0, None, 0.0, MASKED_CARRIER[key]
            else:
                bnd, by = bound_ms(*bnd_of[0], BF16_FLOPS)
                bnd_all = bound_ms(*bnd_of[1], BF16_FLOPS)[0]
            r["max_abs_err"] = max(r["max_abs_err"], errs[key])
            r["max_err_over_scale"] = max(r["max_err_over_scale"], rel[key])
            r["ms"] += count * ms
            r["plain_ms"] += count * plain_ms
            r["library_ms"] += count * lib
            r["bound_ms"] += count * bnd
            r["bound_ms_all_sites"] += count * bnd_all
            r["launch_bytes"] += count * moved
            if by and count * bnd >= largest.get(key, 0.0):  # the stage that dominates
                largest[key], r["bound_by"] = count * bnd, by
            plan = plan_of(inputs[0], key, m)
            r.setdefault("plans", {})[f"C={c}"] = plan
            emit({"kernel_shape": {"kernel": key, "shape": [m, c], "kept_sites": kept,
                                   "per_step": count, "ms": ms, "plain_ms": plain_ms,
                                   "library_ms": lib, "bound_ms": bnd, "bound_by": by,
                                   "bound_ms_all_sites": bnd_all, "launch_bytes": moved,
                                   "plan": plan, "max_abs_err": errs[key],
                                   "max_err_over_scale": rel[key]}})
        del launches, inputs
        torch.cuda.empty_cache()
    for key, carrier in MASKED_CARRIER.items():
        rows_out[key]["bound_by"] = rows_out[carrier]["bound_by"]
    wide_tail_check(rows_out, gen, masked_parity)
    return rows_out


def dwconv_call_ms(x, dy, iters: int = 40) -> dict:
    """One whole dense dwconv, forward and backward, per call: the port's
    ``dwconv7x7`` (dW from row 11) against the same conv through PyTorch's
    autograd (cuDNN forward, dx and dW), run autograd, port, port, autograd.
    For each, the CUDA-event ms per call and the host's ms per call to
    enqueue it (the loop before its one sync, while the card runs behind)."""
    import torch
    import torch.nn.functional as F

    from mmearth_tpu_torch.ops.dwconv import dwconv7x7

    c, dt = x.shape[-1], x.dtype
    xg = x.detach().requires_grad_()
    w = (0.02 * torch.randn(c, 1, 7, 7, device=x.device)).requires_grad_()
    b = torch.zeros(c, device=x.device, requires_grad=True)

    def port():
        dwconv7x7(xg, w, b).backward(dy)

    def autograd():
        F.conv2d(xg.permute(0, 3, 1, 2), w.to(dt), b.to(dt), padding=3,
                 groups=c).permute(0, 2, 3, 1).backward(dy)

    out = {}
    for name, fn in (("autograd", autograd), ("port", port), ("port", port),
                     ("autograd", autograd)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        enqueue = (time.perf_counter() - t0) * 1e3 / iters
        end.record()
        torch.cuda.synchronize()
        out.setdefault(f"call_{name}_ms", []).append(start.elapsed_time(end) / iters)
        out.setdefault(f"call_{name}_enqueue_ms", []).append(enqueue)
    return out


def phase_dwconv_kernel() -> dict:
    """Row 11: the dense dwconv's weight-gradient kernel against its plain
    version at the finetune, decoder and masked-dense shapes, in bf16 and
    f32; times in bf16, with the whole conv's cost per call beside
    (:func:`dwconv_call_ms`).  The row's numbers are the finetune step's;
    ``masked_dense_step`` and ``decoder`` give the other paths' sums."""
    import torch

    from mmearth_tpu_torch.ops import dwconv

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    row = {"name": "dw_weight_grad", "route": "cuda", "source": "mmearth_tpu_torch/csrc/dwconv.cu",
           "replaces": "mmearth_tpu/ops/dwconv.py:32", "launches": 0, "max_abs_err": 0.0,
           "max_err_over_scale": 0.0, "library": "aten.convolution_backward, dW only (cuDNN)"}
    paths = {"finetune": [(FT_BATCH, *g) for g in FT_GEOMS],
             "masked_dense_step": [(N, *g) for g in DENSE_GEOMS] + [(N, *DECODER_GEOM)],
             "decoder": [(N, *DECODER_GEOM)]}
    sums = {}
    for path, geoms in paths.items():
        tot = sums.setdefault(path, {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                                     "bound_ms": 0.0, "bound_by": "bytes", "launches_per_step": 0})
        largest = 0.0
        for n, h, c, count in geoms:
            for dt in (torch.float32, torch.bfloat16):  # timed in the working dtype, bf16
                x = torch.randn(n, h, h, c, generator=gen, device=dev).to(dt)
                dy = torch.randn(n, h, h, c, generator=gen, device=dev).to(dt)
                ref = dwconv.dw_weight_grad_plain(x, dy)
                err = check_close(f"dw_weight_grad {dt} N={n} H={h} C={c}",
                                  dwconv._wgrad_cuda(x, dy), ref, sum_bound(ref))
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["max_err_over_scale"] = max(row["max_err_over_scale"],
                                                err / float(ref.abs().max()))
            xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            w = torch.zeros(c, 1, 7, 7, dtype=dt, device=dev)

            def lib():
                return torch.ops.aten.convolution_backward(
                    dyn, xn, w, None, [1, 1], [3, 3], [1, 1], False, [0, 0], c,
                    [False, True, False])[1]

            lib_err = float((lib().float().reshape(c, 49) - ref.reshape(c, 49)).abs().max())
            ms = time_ms(lambda: dwconv._wgrad_cuda(x, dy))
            plain = time_ms(lambda: dwconv.dw_weight_grad_plain(x, dy))
            lib_ms = time_ms(lib)
            elems = n * h * h * c
            # bf16 products are exact in f32, so bf16 inputs take the bf16
            # tensor-core rate; f32 inputs the f32 rate
            bnd, by = bound_ms(2 * elems * x.element_size() + 49 * c * 4, 2 * 49 * elems,
                               BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS)
            for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib_ms),
                           ("bound_ms", bnd)):
                tot[key] += count * v
            tot["launches_per_step"] += count
            if count * bnd >= largest:
                largest, tot["bound_by"] = count * bnd, by
            calls = dwconv_call_ms(x, dy)
            emit({"kernel_shape": {"kernel": "dw_weight_grad", "path": path, "shape": [n, h, h, c],
                                   "per_step": count, "ms": ms, "plain_ms": plain,
                                   "library_ms": lib_ms, "library_max_abs_err": lib_err,
                                   "bound_ms": bnd, "bound_by": by,
                                   "plan": dwconv.launch_plan(x)._asdict(), **calls}})
            del x, dy, xn, dyn, ref
            torch.cuda.empty_cache()
    row.update({k: sums["finetune"][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by")})
    row["masked_dense_step"] = sums["masked_dense_step"]
    row["decoder"] = sums["decoder"]
    return {"dw_weight_grad": row}


def phase_data(name: str = "smoke_data", n: int = 1170, tile: int = 64) -> Path:
    """Synthetic packed data for the slices, written anew on every run: 1,170
    64-px samples (1,024 train + 146 val) for the atto slices, 292 128-px
    ones (256 + 36) for the pico 112/16 slice."""
    from mmearth_tpu_torch.data.synthetic import generate_packed

    data = ROOT / "build" / name
    shutil.rmtree(data, ignore_errors=True)
    t0 = time.time()
    generate_packed(data, n=n, tile=tile, seed=0)
    emit({"phase": "data", "seconds": round(time.time() - t0, 2), "path": str(data)})
    return data


GATHERED_KERNELS = ("gather_patches", "scatter_patches", "dwconv7_gathered_fwd",
                    "dwconv7_gathered_bwd")
SLICES = (("gathered", "dwg"), ("gathered", "wholeblock"), ("masked_dense", "auto"),
          ("masked_dense", "fused"))


def expected_launches(sparse_impl: str, block_impl: str, config: tuple) -> tuple[dict, tuple]:
    """Launches a step of every kernel on a pretraining slice of ``config``,
    and the kernels whose row of the kernels line takes its count from this
    slice (each from its own path: rows 1-4 from dwg, 7-10 from wholeblock,
    5-6 from masked_dense fused; row 11 from the finetune slice).  Spill-g
    C's separate dW2 pass runs in the blocks of the stages whose C does not
    fold dW2 (its plan's ``fold``).  The dense dwconv's dW runs in the
    decoder Block (1 a step) and, on masked-dense, in the 12 encoder blocks
    too."""
    import torch

    from mmearth_tpu_torch.configs.config import model_size
    from mmearth_tpu_torch.ops import fused_block as fb

    gathered = sparse_impl == "gathered"
    per_step = dict(zip(GATHERED_KERNELS, (2, 2, 12, 12) if gathered else (0, 0, 0, 0)))
    spillg = gathered and block_impl == "wholeblock"
    masked = not gathered and block_impl == "fused"
    per_step.update(dict.fromkeys(fb.SPILLG_LAUNCHES, 12 if spillg else 0))
    depths, dims = model_size(config[0])
    per_step[SPILLG_WIDE_DW2] = sum(
        d for d, c in zip(depths, dims)
        if spillg and not fb.tail_plan(torch.empty(64, c, dtype=torch.bfloat16, device="cuda"),
                                       "spillg_bwd_c", 64)[0].fold)
    per_step.update(dict.fromkeys(fb.MASKED_LAUNCHES, 12 if masked else 0))
    per_step["dw_weight_grad"] = 1 if gathered else 13
    own = {"dwg": GATHERED_KERNELS, "wholeblock": tuple(key for key, _, _ in SPILLG),
           "fused": fb.MASKED_LAUNCHES}.get(block_impl, ())
    return per_step, own


def launch_counters() -> tuple:
    from mmearth_tpu_torch.ops import dwconv
    from mmearth_tpu_torch.ops import fused_block as fb
    from mmearth_tpu_torch.ops import patch_select as ps
    from mmearth_tpu_torch.ops import wholeblock as wb

    return ps.LAUNCHES, wb.LAUNCHES, fb.LAUNCHES, dwconv.LAUNCHES


def reset_launches() -> None:
    for d in launch_counters():
        for key in d:
            d[key] = 0


def read_launches() -> dict:
    from mmearth_tpu_torch import ops

    return ops.launch_counts()


# (model, input size, patch size, batch) of the pretraining slices: atto 56/8
# (the main path) and pico 112/16 (the CLI's defaults, bench.py's tiny112)
ATTO56 = ("convnextv2_atto", 56, 8, 256)
PICO112 = ("convnextv2_pico", 112, 16, PICO_N)


def slice_args(sparse_impl: str, block_impl: str, data: Path, config: tuple, *extra):
    from mmearth_tpu_torch import main_pretrain

    model_name, size, patch, batch = config
    return main_pretrain.get_args_parser().parse_args([
        "--model", model_name, "--input_size", str(size), "--patch_size", str(patch),
        "--batch_size", str(batch), "--use_bf16", "True", "--device", "cuda",
        "--processed_dir", str(data), "--epochs", "3", "--warmup_epochs", "1",
        "--seed", "0", "--sparse_impl", sparse_impl, "--block_impl", block_impl, *extra])


def check_launches(what: str, launches: dict, per_step: dict, steps: int) -> None:
    for name, k in per_step.items():
        if launches[name] != k * steps:
            raise AssertionError(f"{what}, {name}: {launches[name]} launches in {steps} steps, "
                                 f"expected {k} per step")


def phase_slice(rows_out: dict, card: str, sparse_impl: str, block_impl: str, data: Path,
                output_dir: Path | None = None, config: tuple = ATTO56) -> dict:
    """A pretraining slice through ``main_pretrain.main`` (saving its
    checkpoints in ``output_dir`` when given, the newest two kept); its
    launches set the rows' counts only on the atto configuration."""
    import torch

    from mmearth_tpu_torch import main_pretrain

    model_name, size, patch, batch = config
    extra = ["--output_dir", str(output_dir), "--save_ckpt_num", "2"] if output_dir else []
    args = slice_args(sparse_impl, block_impl, data, config, *extra)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    model, history, opt = main_pretrain.main(args)
    launches = read_launches()
    steps = sum(e["steps"] for e in history)
    losses = [x for e in history for x in e["step_losses"]]
    if steps < 10 or len(losses) != steps:
        raise AssertionError(f"slice ran {steps} steps")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        raise AssertionError(f"non-finite loss in {losses}")
    per_step, own = expected_launches(sparse_impl, block_impl, config)
    check_launches(f"{model_name} {sparse_impl} {block_impl} slice", launches, per_step, steps)
    for name in own if config == ATTO56 else ():
        rows_out[name]["launches"] = launches[name]
    steady = history[1:]  # epoch 0 holds the first-call set-up
    ms = 1e3 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    result = {"phase": "slice", "model": model_name, "input_size": size, "patch_size": patch,
              "sparse_impl": sparse_impl, "block_impl": block_impl,
              "steps": steps, "epochs": len(history), "launches": launches,
              "losses": losses, "epoch_loss": [e["loss"] for e in history],
              "ms_per_step": ms, "samples_per_s": batch * 1e3 / ms,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card}
    emit(result)
    if output_dir is not None:
        phase_checkpoint(args, model, opt, output_dir, len(history), per_step)
    return result


def phase_checkpoint(args, model, opt, output_dir: Path, epochs: int, per_step: dict) -> None:
    """The slice's last checkpoint, loaded from disk into a fresh model and
    AdamW, equals the in-memory ones bit for bit; then ``main_pretrain.main``
    with one epoch more on the same directory auto-resumes after it, runs
    that one epoch (with the slice's launches a step) and leaves the newest
    two checkpoints."""
    import torch

    from mmearth_tpu_torch import main_pretrain
    from mmearth_tpu_torch.checkpoints import pth_io
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.pretrain import build_model

    t0 = time.time()
    last = output_dir / f"checkpoint-{epochs - 1}.pth"
    cfg = main_pretrain.config_from_args(args)
    fresh = build_model(cfg, args.device)
    fresh_opt = AdamW(fresh.named_parameters(), opt.lr_schedule)
    if pth_io.restore(last, fresh, fresh_opt) != epochs - 1:
        raise AssertionError(f"{last}: not the epoch {epochs - 1} checkpoint")
    loaded = fresh.state_dict()
    pairs = [(f"model.{k}", v, loaded[k]) for k, v in model.state_dict().items()]
    theirs = fresh_opt.state_dict()
    for key, mine in opt.state_dict().items():
        if isinstance(mine, dict):
            pairs += [(f"optimizer.{key}.{k}", v, theirs[key][k]) for k, v in mine.items()]
        elif mine != theirs[key]:
            raise AssertionError(f"checkpoint optimizer.{key}: {theirs[key]} != {mine}")
    unequal = [k for k, a, b in pairs if not torch.equal(a, b)]
    if unequal:
        raise AssertionError(f"{last} differs from the run's memory at {unequal[:5]}")
    args.epochs = epochs + 1
    reset_launches()
    _, history, resumed_opt = main_pretrain.main(args)
    launches = read_launches()
    if [e["epoch"] for e in history] != [epochs]:
        raise AssertionError(f"resume ran epochs {[e['epoch'] for e in history]}, not [{epochs}]")
    steps = history[0]["steps"]
    check_launches("resumed wholeblock slice", launches, per_step, steps)
    kept = [e for e, _ in pth_io.numbered_checkpoints(output_dir)]
    if kept != [epochs - 1, epochs]:
        raise AssertionError(f"checkpoints kept after the resume: {kept}, expected "
                             f"{[epochs - 1, epochs]} (--save_ckpt_num 2)")
    emit({"phase": "checkpoint", "file": str(last.relative_to(ROOT)), "tensors_equal": len(pairs),
          "resumed_epochs": [e["epoch"] for e in history], "resumed_steps": steps,
          "optimizer_count": resumed_opt.count, "kept": kept,
          "losses": history[0]["step_losses"], "seconds": round(time.time() - t0, 2)})


# kernel symbols (as the profiler names them) -> the launch keys that run them
KERNEL_SYMBOLS = (
    (r"patch_copy_(bulk|reg)<.*\bfalse>", ("gather_patches",)),
    (r"patch_copy_(bulk|reg)<.*\btrue>", ("scatter_patches",)),
    (r"\bdw7_fwd_kernel<", ("dwconv7_gathered_fwd",)),
    (r"\bdw7_bwd_kernel<", ("dwconv7_gathered_bwd",)),
    (r"\bdw7_wgrad_kernel<", ("dw_weight_grad",)),
    (r"\bfwd_stat_kernel<.*SpillRows", ("spillg_fwd_a",)),
    (r"\bspillg_fwd_b_kernel<", ("spillg_fwd_b",)),
    (r"\bspillg_bwd_c_kernel<", ("spillg_bwd_c",)),
    (r"\bbwd_dv_kernel<.*SpillRows", ("spillg_bwd_d",)),
    (r"\bspillg_atb_kernel<[^,]+, false>", ("spillg_bwd_c_dw2", "spillg_bwd_d_dw1")),
    (r"\bmasked_fwd_rows_kernel<", ("masked_rows",)),
    (r"\bfwd_stat_kernel<.*KeptRows", ("masked_fwd_stat",)),
    (r"\bmasked_fwd_apply_kernel<", ("masked_fwd_apply",)),
    (r"\bmasked_bwd_stat_kernel<", ("masked_bwd_stat",)),
    (r"\bbwd_dv_kernel<.*KeptRows", ("masked_bwd_dv",)),
    (r"\bspillg_atb_kernel<[^,]+, true>", ("masked_bwd_stat_dw2", "masked_bwd_dv_dw1")),
)


def profiled_launches(run) -> tuple[dict, dict]:
    """Kernels the card ran during ``run()``, by their launch keys (keys that
    share a kernel symbol share its count), from one torch.profiler trace;
    and the window's host wall ms, the union of its device activity in ms
    (kernels, copies, sets) and the count of its device events."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in device):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    names = [e.name for e in device]
    counts = {keys: sum(1 for n in names if re.search(pattern, n))
              for pattern, keys in KERNEL_SYMBOLS}
    return counts, {"wall_ms": wall, "busy_ms": busy / 1e3, "idle_share": 1 - busy / 1e3 / wall,
                    "device_events": len(device)}


def ulps_apart(a, b):
    """Element by element, how many representable f32 values lie between
    ``a`` and ``b`` (their bit patterns mapped to integers in the order of
    the values), flattened."""
    import torch

    def ordered(x):
        i = x.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a) - ordered(b)).abs().flatten()


def check_replay(what: str, chained, per_step: dict) -> dict:
    """The launches a ChainedStep's capture recorded, per captured step, and
    its replays' sum, against ``per_step``."""
    k = chained.k
    for pattern, rec in chained.recorded.items():
        check_launches(f"{what}, captured {pattern}", rec, per_step, k)
    check_launches(f"{what}, replays", chained.replayed, per_step, chained.steps["replayed"])
    return {key: n // k for key, n in next(iter(chained.recorded.values())).items()}


def check_profiled(what: str, counts: dict, per_step: dict, steps: int) -> None:
    for keys, n in counts.items():
        want = sum(per_step[key] for key in keys) * steps
        if n != want:
            raise AssertionError(f"{what}: the profiled replay ran {n} kernels of "
                                 f"{'/'.join(keys)}, expected {want}")


GRAPH_K, GRAPH_STEPS = 8, 16


def phase_graph(card: str, sparse_impl: str, block_impl: str, config: tuple = ATTO56,
                update_freq: int = 1) -> dict:
    """Graph against eager: GRAPH_STEPS steps of ``pretrain_step`` from one
    initial state on the bench's resident batch (each step its own crop and
    mask), twice (E1, E2), then the same steps as replays of a ChainedStep of
    GRAPH_K (G).  Atomics reorder f32 sums between any two runs, so G is
    held against the spread of E2 from E1, printed: the losses' largest
    difference, and of the final params the share of elements that differ
    and the median ulps (f32 values between) of those that do, each at most
    twice E2's; where E1 and E2 agree bitwise, G must too.  (On an H100 the
    share and the median hold steady between runs, where the largest ulps
    or |difference| vary threefold.)
    The wrappers' counters must have recorded the path's launches a step
    during the warm-up and the capture, the replays must have run them (the
    capture's record), and one profiled replay must show each kernel the
    path's count of times."""
    import torch

    from mmearth_tpu_torch.configs.config import (DataConfig, ModelConfig, OptimConfig,
                                                  PretrainConfig, RunConfig)
    from mmearth_tpu_torch.data.synthetic import bench_batch
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.pretrain import build_model
    from mmearth_tpu_torch.train.schedule import warmup_cosine
    from mmearth_tpu_torch.train.step import ChainedStep, pretrain_step, to_device

    model_name, size, patch, batch = config
    cfg = PretrainConfig(
        model=ModelConfig(model=model_name, img_size=size, patch_size=patch,
                          block_impl=block_impl, sparse_impl=sparse_impl),
        optim=OptimConfig(update_freq=update_freq), data=DataConfig(batch_size=batch),
        run=RunConfig(seed=0))
    data = to_device(bench_batch(batch, size + 8), "cuda")
    schedule = warmup_cosine(1.5e-4 * batch / 256, 0.0, 200, 40, 1000)

    def fresh():
        model = build_model(cfg, "cuda")
        return model, AdamW(model.named_parameters(), schedule, update_freq=update_freq)

    def state(model, opt):
        return list(model.state_dict().values())

    runs, out = {}, {"phase": "graph", "model": model_name, "input_size": size,
                     "patch_size": patch, "batch": batch, "sparse_impl": sparse_impl,
                     "block_impl": block_impl, "update_freq": update_freq, "k": GRAPH_K,
                     "steps": GRAPH_STEPS, "card": card}
    for name in ("E1", "E2"):
        model, opt = fresh()
        gen = torch.Generator(device="cuda").manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = torch.stack([pretrain_step(model, opt, data, i, gen)["loss"]
                              for i in range(GRAPH_STEPS)]).float()
        torch.cuda.synchronize()
        out[f"eager_ms_per_step_{name}"] = 1e3 * (time.perf_counter() - t0) / GRAPH_STEPS
        out["eager_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[name] = (losses, state(model, opt))
        del model, opt
    model, opt = fresh()
    gen = torch.Generator(device="cuda").manual_seed(0)
    chained = ChainedStep(model, opt, {k: v.expand(GRAPH_K, *v.shape) for k, v in data.items()})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    first = chained(0, gen)[1]
    torch.cuda.synchronize()
    recorded = read_launches()
    t0 = time.perf_counter()
    losses = [first]
    for i in range(GRAPH_K, GRAPH_STEPS, GRAPH_K):
        losses.append(chained(i, gen)[1])
    torch.cuda.synchronize()
    out["graph_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / (GRAPH_STEPS - GRAPH_K)
    out["graph_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["capture_s"] = list(chained.capture_seconds.values())
    runs["G"] = (torch.cat(losses), state(model, opt))

    def distance(a, b) -> dict:
        apart = torch.cat([ulps_apart(x, y) for x, y in zip(a[1], b[1])])
        differ = apart[apart > 0].double()
        return {"loss_max_abs": float((a[0] - b[0]).abs().max()),
                "param_share_differing": differ.numel() / apart.numel(),
                "param_median_ulps": float(differ.median()) if differ.numel() else 0.0,
                "param_max_ulps": int(apart.max()),
                "param_max_abs": max(float((x - y).abs().max()) for x, y in zip(a[1], b[1]))}

    held = ("loss_max_abs", "param_share_differing", "param_median_ulps")
    spread, dist = distance(runs["E2"], runs["E1"]), distance(runs["G"], runs["E1"])
    out.update(eager_spread=spread, graph_vs_eager=dist,
               tolerance=f"{', '.join(held)}: at most twice the eager spread (0: bitwise)",
               losses_E1=runs["E1"][0].tolist(), losses_G=runs["G"][0].tolist())
    per_step, _ = expected_launches(sparse_impl, block_impl, config)
    try:  # the line is printed whatever fails
        for key in held:
            if dist[key] > 2 * spread[key]:
                raise AssertionError(f"graph against eager, {key}: {dist[key]} from E1, "
                                     f"E2 {spread[key]}")
        check_launches(f"{model_name} {block_impl} graph, warm-up and capture", recorded,
                       per_step, 2 * GRAPH_K)
        out["launches_per_captured_step"] = check_replay(f"{model_name} {block_impl} graph",
                                                         chained, per_step)
        profiled, window = profiled_launches(lambda: chained(GRAPH_STEPS, gen))
        out["profiled_replay"] = {**window, "launches": {"/".join(keys): n
                                                         for keys, n in profiled.items() if n}}
        check_profiled(f"{model_name} {block_impl} graph", profiled, per_step, GRAPH_K)
    finally:
        emit(out)
    return out


def phase_cli_graph(card: str, data: Path) -> dict:
    """``main_pretrain.main`` with ``--steps_per_dispatch 8`` on the atto
    ``wholeblock`` smoke data at batch 96: 10 steps an epoch (1,024
    samples), one dispatch of 8 and a tail of 2 single steps, 2 epochs into
    ``build/smoke_graph_out``; finite losses, the tail's and the warm-up's
    and the capture's launches on the counters; then ``--epochs 3`` on the
    same directory resumes after epoch 1 and runs epoch 2 alone."""
    import math

    from mmearth_tpu_torch import main_pretrain
    from mmearth_tpu_torch.checkpoints import pth_io

    out_dir = ROOT / "build" / "smoke_graph_out"
    shutil.rmtree(out_dir, ignore_errors=True)
    config = ATTO56[:3] + (96,)
    per_step, _ = expected_launches("gathered", "wholeblock", config)
    t0 = time.time()
    result = {"phase": "cli_graph", "steps_per_dispatch": GRAPH_K, "batch": config[3],
              "card": card}
    for epochs, want in ((2, [0, 1]), (3, [2])):
        args = slice_args("gathered", "wholeblock", data, config, "--steps_per_dispatch",
                          str(GRAPH_K), "--epochs", str(epochs), "--output_dir", str(out_dir),
                          "--save_ckpt_num", "2")
        reset_launches()
        _, history, opt = main_pretrain.main(args)
        launches = read_launches()
        losses = [x for e in history for x in e["step_losses"]]
        if [e["epoch"] for e in history] != want or any(
                (e["steps"], e["chained_steps"]) != (10, GRAPH_K) for e in history):
            runs = [(e["epoch"], e["steps"], e["chained_steps"]) for e in history]
            raise AssertionError(f"main_pretrain under graph: (epoch, steps, chained) {runs}")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"main_pretrain under graph: losses {losses}")
        singles = sum(e["steps"] - e["chained_steps"] for e in history)
        # every single step, the chain's warm-up and its capture (one pattern)
        check_launches("main_pretrain under graph", launches, per_step, singles + 2 * GRAPH_K)
        result[f"epochs_{epochs}"] = {"epochs": want, "losses": losses,
                                      "epoch_loss": [e["loss"] for e in history],
                                      "optimizer_count": opt.count}
    result["kept"] = [e for e, _ in pth_io.numbered_checkpoints(out_dir)]
    if result["kept"] != [1, 2]:
        raise AssertionError(f"main_pretrain under graph: checkpoints kept {result['kept']}")
    result["seconds"] = round(time.time() - t0, 2)
    emit(result)
    return result


def phase_bench(card: str) -> dict:
    """``scripts/torch_bench.py`` short (2 rounds of 10 steps) as a user runs
    it, reusing the kernels built in ``build/kernels``: its last line is the
    result, for the card this smoke test runs on."""
    t0 = time.time()
    r = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_bench.py"), "--config",
                        "atto56", "--rounds", "2", "--steps", "10"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if r.returncode != 0:
        raise AssertionError(f"torch_bench.py exited {r.returncode}: {last}\n{r.stderr[-3000:]}")
    line = json.loads(last)
    want = {"metric", "value", "unit", "ms_per_step", "peak_mem_gib", "block_impl", "auto_value",
            "eager_value", "card"}
    if not (want <= set(line) and line["value"] > 0 and line["auto_value"] > 0
            and line["eager_value"] > 0
            and line["card"] == card
            and line["metric"] == "mpmae_atto_mmearth64_pretrain_samples_per_sec_per_chip"):
        raise AssertionError(f"torch_bench.py line: {line}")
    emit({"phase": "bench", "seconds": round(time.time() - t0, 2), **line})
    return line


GATE_STEPS, BENCH_ROUNDS, BENCH_STEPS = 500, 4, 30


def phase_gate() -> dict:
    """The synthetic convergence gate of ``scripts/torch_convergence_gate.py``
    at its full 500 steps, held as the script holds it: the loss must drop
    by more than half, and its samples/s must lie within ``SPS_TOLERANCE``
    of its own bench run's.  Its bench run and its chunks are graph
    replays: the counters must hold the wholeblock slice's launches a step
    for the steps their warm-ups ran and their captures recorded, and the
    replays must have run them for every replayed step."""
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_convergence_gate as gate

    t0 = time.time()
    reset_launches()
    report = gate.gate_synthetic(torch.device("cuda"), GATE_STEPS, ATTO56[3], BENCH_ROUNDS,
                                 BENCH_STEPS)
    per_step, _ = expected_launches("gathered", "wholeblock", ATTO56)
    graphs = report["graphs"]
    check_launches("convergence gate, warm-ups and captures (its bench run's included)",
                   read_launches(), per_step,
                   sum(g["steps"]["eager"] + g["steps"]["recorded"] for g in graphs))
    replayed = {key: sum(g["replayed_launches"][key] for g in graphs) for key in per_step}
    check_launches("convergence gate, replays (its bench run's included)", replayed, per_step,
                   sum(g["steps"]["replayed"] for g in graphs))
    emit({"phase": "gate", "seconds": round(time.time() - t0, 2), **report,
          "sps_within_tolerance": abs(report["sps_deviation"]) <= gate.SPS_TOLERANCE})
    if report["failures"]:
        raise AssertionError(f"convergence gate: {report['failures']}")
    return report


def phase_geobench_data() -> Path:
    """Synthetic packed m-eurosat for the finetune slices, written anew."""
    from mmearth_tpu_torch.data.geobench import generate_synthetic_geobench

    data = ROOT / "build" / "smoke_geobench"
    shutil.rmtree(data, ignore_errors=True)
    t0 = time.time()
    generate_synthetic_geobench(data, "m-eurosat", (512, 128, 128), seed=0)
    emit({"phase": "geobench_data", "seconds": round(time.time() - t0, 2), "path": str(data)})
    return data


def phase_finetune(rows_out: dict, card: str, data: Path, checkpoint: Path,
                   probe: bool) -> dict:
    """The GEO-Bench classification recipe (TRAINING.md) from the pretraining
    checkpoint: finetune, or the linear probe.  Finite losses, accuracies in
    [0, 1], 12 dW launches a step (none under the probe, whose trunk is
    frozen) and no other launch."""
    import math

    import torch

    from mmearth_tpu_torch import main_finetune

    args = main_finetune.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--data_set", "m-eurosat", "--finetune", str(checkpoint), "--processed_dir", str(data),
        "--batch_size", str(FT_BATCH), "--epochs", "3", "--blr", "1e-2" if probe else "2e-4",
        "--layer_decay", "0.9", "--weight_decay", "0.3", "--drop_path", "0.1",
        "--smoothing", "0.2", "--use_bf16", "True", "--seed", "0", "--device", "cuda",
        "--linear_probe", str(probe)])
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    out = main_finetune.main(args)
    launches = read_launches()
    history = out["history"]
    steps = sum(e["steps"] for e in history)
    losses = [x for e in history for x in e["step_losses"]]
    if steps < 40 or len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"finetune (probe={probe}): {steps} steps, losses {losses}")
    scores = [e["val_Accuracy"] for e in history] + [out["test_Accuracy"]]
    if not all(isinstance(v, float) and 0.0 <= v <= 1.0 for v in scores):
        raise AssertionError(f"finetune (probe={probe}): accuracies {scores}")
    for name, n in launches.items():
        want = 12 * steps if (name == "dw_weight_grad" and not probe) else 0
        if n != want:
            raise AssertionError(f"finetune (probe={probe}), {name}: {n} launches in {steps} "
                                 f"steps, expected {want}")
    if not probe:
        rows_out["dw_weight_grad"]["launches"] = launches["dw_weight_grad"]
    steady = history[1:]
    ms = 1e3 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    result = {"phase": "finetune", "mode": "linear_probe" if probe else "finetune",
              "steps": steps, "epochs": len(history), "launches": launches,
              "epoch_loss": [e["loss"] for e in history], "val_accuracy": scores[:-1],
              "test_accuracy": scores[-1], "ms_per_step": ms,
              "samples_per_s": FT_BATCH * 1e3 / ms,
              "eval_seconds": [e["eval_seconds"] for e in history],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card}
    emit(result)
    return result


def phase_reference(sparse_impl: str, block_impl: str, size: int = 56, patch: int = 8,
                    dims=(40, 80, 160, 320), depths=(2, 2, 6, 2)) -> None:
    """A small f32 step on the GPU (kernels) against the CPU (plain versions)."""
    import numpy as np
    import torch

    from mmearth_tpu_torch.configs import modalities as M
    from mmearth_tpu_torch.data.synthetic import synthetic_batch
    from mmearth_tpu_torch.models.fcmae import FCMAE, gen_random_mask, zero_nan_inputs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(img_size=size, patch_size=patch, depths=depths, dims=dims,
              grn_group=8, block_impl=block_impl, sparse_impl=sparse_impl,
              inp_modalities=M.INP_MODALITIES, out_modalities=M.OUT_MODALITIES)
    cpu = FCMAE(**kw).init_weights(torch.Generator().manual_seed(1))
    gpu = FCMAE(**kw).cuda()
    gpu.load_state_dict(cpu.state_dict())
    batch = zero_nan_inputs({k: torch.from_numpy(v) for k, v in
                             synthetic_batch(8, size, seed=1).items()})
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
        raise AssertionError(f"{sparse_impl} {block_impl} GPU vs CPU step: loss rel {rel:.2e}, "
                             f"worst grad {worst:.2e}")
    emit({"phase": "reference", "sparse_impl": sparse_impl, "block_impl": block_impl,
          "input_size": size, "patch_size": patch, "dims": list(dims), "loss_cpu": l_cpu,
          "loss_gpu": l_gpu, "loss_rel": rel, "worst_grad_rel": worst})


def phase_reference_classifier() -> None:
    """A small f32 classifier step (drop path 0) on the GPU (the dW kernel)
    against the same step on the CPU (plain dW), loss and every grad."""
    import numpy as np
    import torch

    from mmearth_tpu_torch.losses.finetune import smoothed_cross_entropy
    from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
    from mmearth_tpu_torch.ops import dwconv

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(depths=(1, 1, 1, 1), dims=(16, 32, 48, 64), sparse=False, num_classes=10,
              head_init_scale=1.0)
    cpu = ConvNeXtV2(**kw)
    cpu.init_weights(torch.Generator().manual_seed(1))
    gpu = ConvNeXtV2(**kw).cuda()
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 64, 64, 12, generator=gen)
    y = torch.randint(0, 10, (4,), generator=gen)
    reset_launches()
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        loss = smoothed_cross_entropy(model(x.to(dev)), y.to(dev), 0.2)
        loss.backward()
        out[name] = (float(loss.detach()), {k: p.grad.detach().cpu()
                                            for k, p in model.named_parameters()})
    if read_launches()["dw_weight_grad"] != 4:
        raise AssertionError("classifier step: expected one dW launch per block on the GPU")
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["gpu"]
    rel = abs(l_cpu - l_gpu) / abs(l_cpu)
    worst = max(float((g_gpu[k] - g_cpu[k]).abs().max() / (g_cpu[k].abs().max() + 1e-12))
                for k in g_cpu)
    # f32 on both sides; differences are summation order only
    if not (rel < 1e-4 and worst < 1e-3 and np.isfinite(l_gpu)):
        raise AssertionError(f"classifier GPU vs CPU step: loss rel {rel:.2e}, "
                             f"worst grad {worst:.2e}")
    emit({"phase": "reference", "model": "classifier", "loss_cpu": l_cpu, "loss_gpu": l_gpu,
          "loss_rel": rel, "worst_grad_rel": worst})


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
    rows_out.update(phase_masked_kernels())
    rows_out.update(phase_dwconv_kernel())
    data = phase_data()
    # wiped first: auto-resume would otherwise continue a previous run's checkpoints
    pretrain_out = ROOT / "build" / "smoke_pretrain_out"
    shutil.rmtree(pretrain_out, ignore_errors=True)
    for sparse_impl, block_impl in SLICES:
        phase_slice(rows_out, card, sparse_impl, block_impl, data,
                    pretrain_out if block_impl == "wholeblock" else None)
    phase_slice(rows_out, card, "gathered", "wholeblock",
                phase_data("smoke_data128", n=292, tile=128), config=PICO112)
    geobench = phase_geobench_data()
    for probe in (False, True):
        phase_finetune(rows_out, card, geobench, pretrain_out / "checkpoint-2.pth", probe)
    for sparse_impl, block_impl in (("gathered", "wholeblock"), ("masked_dense", "fused")):
        phase_graph(card, sparse_impl, block_impl)
    phase_graph(card, "gathered", "wholeblock", PICO112, update_freq=2)
    phase_cli_graph(card, data)
    phase_bench(card)
    phase_gate()
    for sparse_impl, block_impl in (("gathered", "dwg"), ("gathered", "wholeblock"),
                                    ("masked_dense", "fused")):
        phase_reference(sparse_impl, block_impl)
    phase_reference("gathered", "wholeblock", 112, 16, (64, 128, 256, 512), (1, 1, 1, 1))
    phase_reference_classifier()
    print(card, flush=True)
    emit({"kernels": list(rows_out.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

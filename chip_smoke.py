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
   step's four stage shapes, the decoder's (256, 7, 7, 512), the four
   masked-dense stage shapes and the segmentation U-Net's four (batch 16,
   grids 56/28/14/7 at C = 40/80/160/320; the row's ``seg``), within 1e-3 * |p| + 1e-4 * max|p| (atomics and
   tiling reorder sums of up to 8e5 terms); its yardstick is cuDNN's dW
   (``aten.convolution_backward``), its bound takes the bf16 rate for bf16
   inputs, and each shape also gives the whole conv's cost per call, port
   against PyTorch's autograd conv, on the card and on the host, and the
   kernel's launch plan.  The stem pair (``stem_rows_fwd``,
   ``stem_rows_bwd``) against its plain version at both benchmark
   configurations' stems, batch 512 (atto56: s = 1, C = 40; tiny112: s = 2,
   C = 96; the row's ``tiny112``), with the tolerances of ``stem_shape``;
   its yardstick is the composed stem on the dense grid and the gather,
   which the gathered path ran before the pair.
3. slices: 1,170 samples of synthetic 64-px mmpack data; the native row
   gather (``data/native``, built with g++ into ``build/native``) gathers
   its shuffled epoch (batches of 256) into pinned memory byte-identical to
   ``np.take``, with samples/s as the driver's loader calls it, at one
   thread and for numpy's pinned gather; then the port's
   ``main_pretrain.main`` at convnextv2_atto 56/8, batch 256, bf16 for 12
   steps over 3 epochs, four times: the gathered encoder with
   ``--block_impl dwg`` and with ``wholeblock``, and ``--sparse_impl
   masked_dense`` with ``--block_impl auto`` (composed tail) and with
   ``fused``.  Every step's loss must be finite and the launch counters, set
   to 0 before each run, must rise by exactly 1/1/12/12 (gather/scatter/
   dwconv fwd/bwd) and 1/1 (the stem pair) per step on the gathered slices
   (2/2/12/12 and no stem pair where the stem is composed: the original stem,
   the tanh GELU) and 0 on the masked-dense ones, 12 of each spill-g launch a step under wholeblock (C's separate
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
   The encoder options, each a 12-step atto slice through
   ``main_pretrain.main`` with its flags: ``--sparse False`` (the leaky
   dense encoder: no gathered or tail launch, the dense dW 13 a step),
   ``--gelu_approx True`` with ``wholeblock`` (the gathered counts, no
   spill-g launch: the kernels compute the erf GELU) and with masked-dense
   ``fused`` (no masked-dense launch), ``--block_impl remat`` and
   ``folded`` (the gathered counts, no tail launch); then
   ``--use_orig_stem True`` at pico-112/16 with ``wholeblock`` (the pico
   slice's counts) into ``build/smoke_orig_stem_out``, its checkpoint held
   and resumed as above.
   ``main_finetune.main`` runs the GEO-Bench classification recipe from
   that ``checkpoint-2.pth`` (convnextv2_atto at patch 8, batch 32, bf16, 3
   epochs of synthetic m-eurosat 512/128/128), once finetuning (12 dW
   launches a step, no other kernel) and once as the linear probe (no
   launch at all), with finite losses and accuracies in [0, 1]; then
   finetuning pico-112/16 with ``--use_orig_stem True`` from the
   original-stem slice's ``checkpoint-2.pth``, whose ``stem_orig.*`` the
   driver's bootstrapped classifier must hold.
   GEO-Bench segmentation: an atto 112/16 pretraining slice (batch 64, the
   wholeblock counts, checkpointed into ``build/smoke_seg_pretrain_out``
   and resumed) writes the checkpoint whose stem (stride 2) fits the
   recipe; synthetic m-cashew-plant (256/64/64, 12 bands) at 112 px and at
   64 px; then ``run_finetune`` from the CLI's config at the recipe
   (``convnextv2_unet_atto`` 112/16, batch 16, bf16) as the linear probe
   unfrozen at epoch 1 of 3: the bootstrapped U-Net must hold the
   checkpoint's trunk, row 11 must launch 0 times a step in the probe epoch
   and 12 after the unfreeze and nothing else may launch, losses finite,
   Jaccard in [0, 1], ms/step and peak GiB printed.  The ResNet baselines
   through ``main_finetune.main`` from foreign files written to
   ``build/smoke_foreign``: ``resnet18`` finetuned on m-eurosat from a
   SeCo-style ``.pth`` and ``resnet18_unet`` as the probe on the 64-px
   m-cashew-plant from a Satlas-style one, each bootstrapped model holding
   the file's backbone, no kernel launched, losses finite, scores in
   [0, 1].  ``main_finetune --opt lamb`` at the finetune recipe (dense atto
   112/16, batch 32) from the atto 112/16 slice's checkpoint on 112-px
   synthetic m-eurosat: 2 epochs (12 row-11 launches a step), then resumed
   for a third under the restored LAMB state.
4. graphs, bench and gate: 16 steps of ``pretrain_step`` run eagerly twice
   and as 2 replays of an 8-step ``train/step.py::ChainedStep`` graph from
   the same state, for atto-56/8 ``wholeblock`` and masked-dense ``fused``
   at batch 256, pico-112/16 ``wholeblock`` at batch 64 with
   ``update_freq`` 2, each encoder option's slice (``remat`` with its tail
   under ``torch.utils.checkpoint`` in the capture) and pico-112/16
   ``wholeblock`` with the original stem: the losses' largest difference
   from the first eager run, and the share of its params that differ and
   their median ulps, at
   most twice the second eager run's (bitwise where the two agree); the
   launches a captured step (the capture's record) and one profiled
   replay's kernels by symbol (``KERNEL_SYMBOLS``) against the slice's
   counts (a trace short of some kernel and over on none has lost events:
   it is printed, and the next replay's trace must hold alone); eager and replay ms/step, capture seconds, peak GiB and the
   replay's idle share printed.  Then ``main_pretrain.main`` with
   ``--steps_per_dispatch 8`` on the atto ``wholeblock`` data at batch 96
   (10 steps an epoch: one
   dispatch and a tail of 2 single steps), 2 epochs into
   ``build/smoke_graph_out``, then resumed for a third, its loader
   gathering through the native core (its calls counted).  Then
   ``scripts/torch_bench.py --config atto56 --rounds 2 --steps 10`` and
   ``--config seg`` the same way as subprocesses (the built kernels
   reused), whose last lines must carry the metrics' keys, rates above 0
   and this card; then the synthetic
   convergence gate of ``scripts/torch_convergence_gate.py`` at its full
   500 steps (batch 256, ``wholeblock``, 50-step graph replays, after its
   own bench run of 4 replays of 30 steps), whose loss must drop by more
   than half and whose samples/s must lie within 10% of its bench's, with
   the slice's launches a step on the counters (warm-ups and captures) and
   in the replays (``ChainedStep.replayed``).
   Then the tools: ``print_diagnostics()``'s report; ``hub.MPMAE`` from the
   ``wholeblock`` slice's ``checkpoint-2.pth``, its logits on the card in
   f32 (TF32 off) within 1e-4 of their scale of the CPU port's on the same
   file and input, 4 finetune steps of the hub model (row 11 12 times a
   step, nothing else) and a probe step (no launch); the reconstruction
   panels' ``run_one_batch`` on 4 samples of the packed data with a CPU
   run's mask under ``auto`` and ``wholeblock``, the maps within 1e-4 of
   their scale of the CPU port's in f32 and the forward's launches the
   forward share of the slice's (``forward_launches``), then
   ``render_panels`` (one PNG a pixel modality where matplotlib is
   installed, else its refusal naming it; printed either way); the model
   FLOPs of an atto56 step counted on the CPU at batch 2 and the MFU
   of the bench's replayed ms/step (0 < MFU < 1; the bench lines carry
   ``mfu`` too); ``utils/profiling.py::time_steps`` on the atto56
   ``wholeblock`` ``ChainedStep`` (every round printed); and
   ``main_pretrain.main`` with ``--wandb True --distributed True`` for one
   epoch with wandb hidden (it runs, and says wandb is missing) and, where
   wandb is installed, with it disabled (``WANDB_MODE``, no network).
   Then data parallelism (``parallel/mesh.py``): (a) ``torchrun
   --standalone --nproc_per_node 1`` running ``main_pretrain.main`` with
   ``--distributed True`` (this script's ``--dist-child`` mode, which
   calls the CLI's ``main`` on its flags and writes the history) at
   atto56 ``wholeblock`` batch 256 with ``--steps_per_dispatch 4``, so
   that the NCCL all-reduces are recorded in the captured graph and
   replayed, its step losses against the same run without a process
   group, ms/step both ways and the gradient all-reduce's time a step,
   then in this process, under a one-rank NCCL group made here, replays
   of an 8-step graph on a resident batch with and without the group,
   turn about (the group's cost with no host input in the step);
   (b) ``main_finetune.main`` under torchrun at world size 1 for the
   classifier and ``resnet18``; (c) two ranks on the one card over gloo,
   f32, the global GRN scope, gathered ``wholeblock`` and masked-dense
   ``fused`` at one block a stage: each rank's loss and averaged gradients
   against one process on the concatenated batch, at the reference
   phases' tolerances, the rows 5-10 launches counted in each rank.
   Then the tensor-parallel ``model`` axis (``phase_model_axis``): two
   gloo ranks on the card as a (1, 2) grid, every ``pwconv1``, ``proj``
   and head split, atto56 at full width and batch 256 in f32 (TF32 off),
   gathered ``wholeblock`` and masked-dense ``fused`` (the kernels fed the
   gathered W1), two AdamW steps against this process at ``model`` 1: the
   losses within 1e-4 relative, the gradients within 1e-3 of scale, the
   params (split leaves concatenated) within 1e-4 of scale plus the gap
   between Adam's steps on the two sides' own gradients, replicated
   leaves bit-identical on the ranks, the path's kernel rows launched on
   each rank, a bf16 step finite; eager ms/step of both and the
   collectives' share of a step; then ``dryrun_multichip`` in the ranks.
5. reference: a small f32 FCMAE step on the GPU against the same step on the
   CPU (plain versions), loss and grads, for dwg, wholeblock and
   masked_dense fused, wholeblock at pico widths 112/16 (one block a
   stage), each encoder option's slice, wholeblock with the original stem
   (at 56/8 and at pico 112/16) and with the stem on the gathered rows
   (``stem_gathered``, both stems), a small f32 classifier step, and
   small f32 steps of the U-Net (the dW kernel), ResNet-18 and the
   ResNet-18 U-Net (with their BN running statistics); and 3 f32 steps of
   that classifier under every ``--opt`` family, GPU against CPU at the
   classifier step's tolerances, with ms a step.
   Then the JAX package's Orbax checkpoint (``phase_orbax``, the committed
   fixture ``tests/fixtures/orbax_pretrain_tiny``): every leaf against its
   checksum, the reader's host seconds and MB/s, the driver's resume on the
   card (f32, TF32 off, ``wholeblock``) against JAX's encoder output and
   next two losses (1e-4 relative), ``main_pretrain --resume`` for an epoch
   and ``main_finetune --finetune`` for one, each with its launches, and
   ``hub.MPMAE`` from the step; then the port's Orbax writer: that run's
   ``checkpoint-1.pth`` written as a step, read back and resumed on the
   card, bit-equal to the ``.pth`` with the next micro-step's loss equal to
   the ``.pth``'s resume, and the atto56 slice's ``checkpoint-2.pth``
   written and read back at full width, each write and read timed.
6. optional packages: ``--loader hdf5`` (h5py), ``--loader grain``
   (array_record) and ``--log_dir`` (tensorboardX) through
   ``main_pretrain.main``: refused before the first step, naming the
   package, where it is missing; 2 steps where it is present.

The last three lines are the card's name and power limit, one JSON object
with a row per kernel, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
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
SEG_BATCH = 16  # the segmentation recipe's batch (bench.py:507-529)
SEG_GEOMS = ((56, 40, 2), (28, 80, 2), (14, 160, 6), (7, 320, 2))  # atto 112/16, stem stride 2
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
    version at the finetune, decoder, masked-dense and segmentation U-Net
    shapes, in bf16 and f32; times in bf16, with the whole conv's cost per
    call beside (:func:`dwconv_call_ms`).  The row's numbers are the
    finetune step's; ``masked_dense_step``, ``decoder`` and ``seg`` (the
    U-Net's 12 encoder Blocks at batch 16, 112/16) give the other paths'
    sums."""
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
             "decoder": [(N, *DECODER_GEOM)],
             "seg": [(SEG_BATCH, *g) for g in SEG_GEOMS]}
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
    row["seg"] = {**sums["seg"], "launches": 0}  # launches: the seg probe's run
    return {"dw_weight_grad": row}


# the stem kernel pair's shapes: the benchmark's configurations at its batch
# (name, batch, image side, patch side, stem width)
STEM_SHAPES = (("atto56", 512, 56, 8, 40), ("tiny112", 512, 112, 16, 96))


def stem_composed(y, kept, inv, s, leaves):
    """The composed stem after the initial conv on the dense grid, then the
    gather: ``ConvNeXtV2._stem``'s LN -> mask -> GELU -> depthwise conv ->
    LN -> mask and ``gather_patches``, as the gathered encoder ran it before
    the kernel pair (the pair's yardstick; the port no longer calls it on
    this path)."""
    import torch.nn.functional as F

    from mmearth_tpu_torch.models.convnextv2 import upsample_mask
    from mmearth_tpu_torch.ops.patch_select import gather_patches
    from mmearth_tpu_torch.ops.stem import _layer_norm

    n, h, _, c = y.shape
    dt = y.dtype
    keep = 1.0 - (inv == kept.shape[1]).float()
    u = _layer_norm(y, leaves[0], leaves[1], 1e-6, dt) * upsample_mask(keep, GRID, h).to(dt)
    z = F.conv2d(F.gelu(u).permute(0, 3, 1, 2), leaves[2].to(dt), leaves[3].to(dt), s,
                 groups=c).permute(0, 2, 3, 1)
    z = _layer_norm(z, leaves[4], leaves[5], 1e-6, dt) * upsample_mask(keep, GRID, h // s).to(dt)
    return gather_patches(z.contiguous(), kept, inv, h // s // GRID, GRID)


def stem_shape(gen, n, img, patch, c) -> tuple[dict, dict]:
    """The kernel pair at one configuration's stem, bf16 with TF32 off: the
    rows within one bf16 ulp plus 1e-4 of their scale of the plain
    version's but for at most 1e-5 of them, and all within 2^-6 of their
    scale (where an LN1 output or the conv output, rounded to bf16 from f32
    statistics summed in another order, lands on the other side of a
    rounding boundary, z moves by one ulp and LN2 carries that to the row as
    |LN2 weight| ulp(z) / std(z), many ulps of a row near 0), d(y) within 2^-6 of its scale and exactly 0 at removed
    patches, each leaf's f32 sum within 2^-7 of each value plus 2^-6 of the
    leaf's scale (the plain version rounds the taps' gradients to bf16 as
    autograd does); each direction timed beside the plain version and the
    composed stem and gather (forward; autograd backward), its bound the
    bytes it must move once."""
    import torch

    from mmearth_tpu_torch.models.convnextv2 import visible_ids
    from mmearth_tpu_torch.models.fcmae import gen_random_mask
    from mmearth_tpu_torch.ops import stem as st

    dev, bf, s = gen.device, torch.bfloat16, patch // 8
    kept, inv = visible_ids(gen_random_mask(n, GRID * GRID, 0.6, gen, dev), K)
    y = (torch.randn(n, img, img, c, generator=gen, device=dev)
         + torch.randn(c, generator=gen, device=dev)).to(bf)
    leaves = [1 + 0.5 * torch.randn(c, generator=gen, device=dev),
              0.5 * torch.randn(c, generator=gen, device=dev),
              torch.randn(c, 1, s, s, generator=gen, device=dev),
              0.5 * torch.randn(c, generator=gen, device=dev),
              1 + 0.5 * torch.randn(c, generator=gen, device=dev),
              0.5 * torch.randn(c, generator=gen, device=dev)]
    prm = st.param_rows(*leaves, bf)
    q = img // GRID // s
    dr = torch.randn(n, K, q, q, c, generator=gen, device=dev).to(bf)
    rows = st._fwd_cuda(y, kept, prm, GRID, s, 1e-6, 1e-6)
    dy, g = st._bwd_cuda(y, dr, kept, inv, prm, GRID, s, 1e-6, 1e-6)
    torch.cuda.synchronize()
    yp = y.detach().requires_grad_()
    lp = [t.detach().requires_grad_() for t in leaves]
    ref = st.stem_rows_plain(yp, kept, GRID, s, *lp)
    ref.backward(dr, retain_graph=True)
    over = int(((rows.float() - ref.float()).abs() > ulp_bound(ref)).sum())
    if over > 1e-5 * ref.numel():
        raise AssertionError(f"stem_rows {img}/{patch} rows: {over} of {ref.numel()} past one ulp")
    err_rows = check_close(f"stem_rows {img}/{patch} rows", rows, ref,
                           2 ** -6 * float(ref.float().abs().max()))
    err_dy = check_close(f"stem_rows {img}/{patch} dy", dy, yp.grad,
                         2 ** -6 * float(yp.grad.float().abs().max()))
    removed = (inv == K).reshape(n, GRID, 1, GRID, 1).expand(n, GRID, img // GRID, GRID,
                                                             img // GRID)
    if bool(dy.reshape(n, GRID, img // GRID, GRID, img // GRID, c)[removed].any()):
        raise AssertionError(f"stem_rows {img}/{patch}: d(y) not 0 at removed patches")
    err_leaf = 0.0
    for name, got, want in zip(("ln1_w", "ln1_b", "tap_w", "tap_b", "ln2_w", "ln2_b"),
                               st.leaf_grads(g, s), (t.grad for t in lp)):
        err = check_close(f"stem_rows {img}/{patch} {name}", got, want,
                          2 ** -7 * want.abs() + 2 ** -6 * float(want.abs().max()))
        err_leaf = max(err_leaf, err / float(want.abs().max()))
    lib = stem_composed(yp, kept, inv, s, lp)
    ids = kept.numel() * 4
    in_vis, out_rows = n * K * (q * s) ** 2 * c * 2, n * K * q * q * c * 2
    plan = {"fwd_blocks": st._config(y, K, GRID, s, False)[1],
            "bwd_blocks": st._config(y, K, GRID, s, True)[1]}
    fwd = launch_summary(
        [n, img, img, c], err_rows, lambda: st._fwd_cuda(y, kept, prm, GRID, s, 1e-6, 1e-6),
        lambda: st.stem_rows_plain(y, kept, GRID, s, *leaves),
        lambda: stem_composed(y, kept, inv, s, leaves), in_vis + out_rows + ids, 0)
    part = (plan["bwd_blocks"] + -(-plan["bwd_blocks"] // st.BLOCK_GROUP)) * prm.numel() * 4
    bwd = launch_summary(
        [n, img, img, c], err_dy,
        lambda: st._bwd_cuda(y, dr, kept, inv, prm, GRID, s, 1e-6, 1e-6),
        lambda: ref.backward(dr, retain_graph=True), lambda: lib.backward(dr, retain_graph=True),
        in_vis + out_rows + n * img * img * c * 2 + inv.numel() * 4 + 2 * part, 0)
    group, pairs = st.lane_plan(c, s * s)
    fwd["plan"] = bwd["plan"] = {**plan, "lanes_a_site": group, "pairs_a_lane": pairs,
                                 "taps": s * s}
    bwd["leaf_err_over_scale"] = err_leaf
    del y, yp, dy, ref, lib
    torch.cuda.empty_cache()
    return fwd, bwd


def phase_stem_kernel() -> dict:
    """The stem kernel pair (``stem_rows_fwd``, ``stem_rows_bwd``) at both
    benchmark configurations' stems, batch 512 (``stem_shape``); the rows'
    numbers are atto56's, ``tiny112`` gives tiny112's."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(4)
    rows = {key: {"name": key, "route": "cuda", "source": "mmearth_tpu_torch/csrc/stem.cu",
                  "replaces": "none (the composed stem and gather_patches)", "launches": 0,
                  "library": "the composed stem after the initial conv, then gather_patches"}
            for key in ("stem_rows_fwd", "stem_rows_bwd")}
    for name, n, img, patch, c in STEM_SHAPES:
        for key, summary in zip(rows, stem_shape(gen, n, img, patch, c)):
            emit({"kernel_shape": {"kernel": key, "path": name, "per_step": 1, **summary}})
            if name == "atto56":
                rows[key].update(summary)
            else:
                rows[key][name] = summary
    return rows


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


def phase_native_gather(card: str, data: Path) -> dict:
    """The native row gather (``data/native``): built with g++ into
    ``build/native``, then the atto smoke pack's shuffled epoch (1,024
    samples, batches of 256, each batch's rows sorted as the loader sorts
    them) gathered into pinned memory as the driver's loader gathers it (up
    to ``--num_workers`` 10 threads, ``threads_for``'s rule) and on one
    thread, every field byte-identical to ``np.take`` into the same pinned
    buffers; samples/s of each, best of 3 passes."""
    import numpy as np

    from mmearth_tpu_torch.configs.config import DataConfig
    from mmearth_tpu_torch.data import native
    from mmearth_tpu_torch.data.loader import PackedDataset, PackedLoader, pinned_empty

    t0 = time.time()
    lib = native.build()
    build_s = time.time() - t0
    ds = PackedDataset(data / "train")
    batches = [np.sort(r) for r in PackedLoader(ds, batch_size=N, seed=0)._epoch_batches()]

    def numpy_pass():
        out = []
        for rows in batches:
            b = {}
            for name, arr in ds.arrays.items():
                b[name] = pinned_empty((len(rows), *arr.shape[1:]), arr.dtype)
                native.take_rows(arr, rows, out=b[name].numpy())
            out.append(b)
        return out

    threads = DataConfig().num_workers
    passes = {"native_loader": lambda: [ds.gather(r, pin=True, n_threads=threads)
                                        for r in batches],
              "native_1_thread": lambda: [ds.gather(r, pin=True, n_threads=1) for r in batches],
              "numpy_pinned": numpy_pass}
    ref = numpy_pass()
    for name, run in passes.items():
        for got, want in zip(run(), ref):
            for key, t in want.items():
                if got[key].numpy().tobytes() != t.numpy().tobytes():
                    raise AssertionError(f"native gather ({name}), {key}: not np.take's bytes")
    sps = {}
    for name, run in passes.items():
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        sps[name] = len(batches) * N / best
    sample_bytes = sum(a[0].nbytes for a in ds.arrays.values())
    result = {"phase": "native_gather", "library": str(lib.relative_to(ROOT)),
              "build_s": round(build_s, 2), "batches": len(batches), "batch": N,
              "sample_mbytes": sample_bytes / 1e6, "byte_identical": True,
              "loader_threads": {k: native.threads_for(a[0].nbytes * N, threads)
                                 for k, a in ds.arrays.items()},
              "readahead": ds.readahead,
              **{f"{k}_sps": v for k, v in sps.items()}, "host_cores": os.cpu_count(),
              "card": card}
    emit(result)
    return result


GATHERED_KERNELS = ("gather_patches", "scatter_patches", "dwconv7_gathered_fwd",
                    "dwconv7_gathered_bwd")
STEM_KERNELS = ("stem_rows_fwd", "stem_rows_bwd")
SLICES = (("gathered", "dwg"), ("gathered", "wholeblock"), ("masked_dense", "auto"),
          ("masked_dense", "fused"))
# the encoder options' atto slices: the leaky encoder, the tanh GELU on both
# kernel-tail paths, the rematerialized and the norm-folded tails
OPTION_SLICES = (("gathered", "auto", {"sparse": False}),
                 ("gathered", "wholeblock", {"gelu_approx": True}),
                 ("masked_dense", "fused", {"gelu_approx": True}),
                 ("gathered", "remat", {}), ("gathered", "folded", {}))


def expected_launches(sparse_impl: str, block_impl: str, config: tuple, sparse: bool = True,
                      gelu_approx: bool = False, use_orig_stem: bool = False
                      ) -> tuple[dict, tuple]:
    """Launches a step of every kernel on a pretraining slice of ``config``
    (and its encoder options; 12 Blocks at atto and pico, each launching
    the block kernels once a step), and the kernels whose row of the kernels line
    takes its count from this slice (each from its own path: rows 1-4 from
    dwg, 7-10 from wholeblock, 5-6 from masked_dense fused; row 11 from the
    finetune slice).  Spill-g C's separate dW2 pass runs in the blocks of
    the stages whose C does not fold dW2 (its plan's ``fold``).  The dense
    dwconv's dW runs in the decoder Block (1 a step) and, on masked-dense
    and the leaky encoder (``sparse`` False, no gathered launch), in the 12
    encoder blocks too.  The kernel tails compute
    the erf GELU, so under ``gelu_approx`` no tail kernel runs; ``remat``
    and ``folded`` compose their tails around the gathered dwconv.  The
    gathered stem is the stem pair, one launch each a step, in place of the
    stem's gather and its VJP's scatter, except where the stem composes:
    the original stem (its output gathered as the stem's) and the tanh GELU."""
    import torch

    from mmearth_tpu_torch.configs.config import model_size
    from mmearth_tpu_torch.ops import fused_block as fb
    from mmearth_tpu_torch.ops.stem import supported as stem_supported

    gathered = sparse and sparse_impl == "gathered"
    depths, dims = model_size(config[0])
    blocks = sum(depths)
    stem = (gathered and not gelu_approx and not use_orig_stem
            and stem_supported(dims[0], config[2] // 8))
    patches = 2 - stem  # the stem's gather and its VJP's scatter go into the stem pair
    per_step = dict(zip(GATHERED_KERNELS,
                        (patches, patches, blocks, blocks) if gathered else (0, 0, 0, 0)))
    per_step.update(dict.fromkeys(STEM_KERNELS, int(stem)))
    spillg = gathered and block_impl == "wholeblock" and not gelu_approx
    masked = sparse and not gathered and block_impl == "fused" and not gelu_approx
    per_step.update(dict.fromkeys(fb.SPILLG_LAUNCHES, blocks if spillg else 0))
    per_step[SPILLG_WIDE_DW2] = sum(
        d for d, c in zip(depths, dims)
        if spillg and not fb.tail_plan(torch.empty(64, c, dtype=torch.bfloat16, device="cuda"),
                                       "spillg_bwd_c", 64)[0].fold)
    per_step.update(dict.fromkeys(fb.MASKED_LAUNCHES, blocks if masked else 0))
    per_step["dw_weight_grad"] = 1 if gathered else 1 + blocks
    own = {"dwg": GATHERED_KERNELS + STEM_KERNELS, "wholeblock": tuple(key for key, _, _ in SPILLG),
           "fused": fb.MASKED_LAUNCHES}.get(block_impl, ())
    return per_step, own


def launch_counters() -> tuple:
    from mmearth_tpu_torch.ops import dwconv
    from mmearth_tpu_torch.ops import fused_block as fb
    from mmearth_tpu_torch.ops import patch_select as ps
    from mmearth_tpu_torch.ops import stem
    from mmearth_tpu_torch.ops import wholeblock as wb

    return ps.LAUNCHES, wb.LAUNCHES, fb.LAUNCHES, dwconv.LAUNCHES, stem.LAUNCHES


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


def option_flags(options: dict) -> list[str]:
    """CLI flags of encoder options, e.g. {"sparse": False} -> --sparse False."""
    return [x for key, value in options.items() for x in (f"--{key}", str(value))]


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
                output_dir: Path | None = None, config: tuple = ATTO56,
                options: dict | None = None) -> dict:
    """A pretraining slice through ``main_pretrain.main`` with the encoder
    ``options`` as flags (saving its checkpoints in ``output_dir`` when
    given, the newest two kept); its launches set the rows' counts only on
    the atto configuration without options."""
    import torch

    from mmearth_tpu_torch import main_pretrain

    model_name, size, patch, batch = config
    options = options or {}
    extra = ["--output_dir", str(output_dir), "--save_ckpt_num", "2"] if output_dir else []
    args = slice_args(sparse_impl, block_impl, data, config, *extra, *option_flags(options))
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
    per_step, own = expected_launches(sparse_impl, block_impl, config, **options)
    check_launches(f"{model_name} {sparse_impl} {block_impl} {options} slice", launches,
                   per_step, steps)
    for name in own if (config == ATTO56 and not options) else ():
        rows_out[name]["launches"] = launches[name]
    steady = history[1:]  # epoch 0 holds the first-call set-up
    ms = 1e3 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    result = {"phase": "slice", "model": model_name, "input_size": size, "patch_size": patch,
              "sparse_impl": sparse_impl, "block_impl": block_impl, "options": options,
              "launches_per_step": per_step, "steps": steps, "epochs": len(history),
              "launches": launches,
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
    check_launches("resumed slice", launches, per_step, steps)
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
    (r"\bstem_rows_fwd_kernel<", ("stem_rows_fwd",)),
    (r"\bstem_rows_bwd_kernel<", ("stem_rows_bwd",)),
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


def short_trace(counts: dict, per_step: dict, steps: int) -> bool:
    """Whether a profiled window shows fewer of some kernel, and more of
    none, than ``steps`` steps launch: the sign of a trace that lost events."""
    diffs = [n - sum(per_step[key] for key in keys) * steps for keys, n in counts.items()]
    return min(diffs) < 0 and max(diffs) <= 0


def check_profiled(what: str, counts: dict, per_step: dict, steps: int) -> None:
    for keys, n in counts.items():
        want = sum(per_step[key] for key in keys) * steps
        if n != want:
            raise AssertionError(f"{what}: the profiled replay ran {n} kernels of "
                                 f"{'/'.join(keys)}, expected {want}")


GRAPH_K, GRAPH_STEPS = 8, 16


def phase_graph(card: str, sparse_impl: str, block_impl: str, config: tuple = ATTO56,
                update_freq: int = 1, options: dict | None = None) -> dict:
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
    path's count of times.  ``options``: encoder options of ModelConfig."""
    import torch

    from mmearth_tpu_torch.configs.config import (DataConfig, ModelConfig, OptimConfig,
                                                  PretrainConfig, RunConfig)
    from mmearth_tpu_torch.data.synthetic import bench_batch
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.pretrain import build_model
    from mmearth_tpu_torch.train.schedule import warmup_cosine
    from mmearth_tpu_torch.train.step import ChainedStep, pretrain_step, to_device

    model_name, size, patch, batch = config
    options = options or {}
    cfg = PretrainConfig(
        model=ModelConfig(model=model_name, img_size=size, patch_size=patch,
                          block_impl=block_impl, sparse_impl=sparse_impl, **options),
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
                     "block_impl": block_impl, "options": options,
                     "update_freq": update_freq, "k": GRAPH_K,
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
    per_step, _ = expected_launches(sparse_impl, block_impl, config, **options)
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
        if short_trace(profiled, per_step, GRAPH_K):
            # A graph replays every kernel it recorded, but a trace has
            # been seen to lose a step's events (1,989 fewer device events
            # than another run of the same graph): that trace is printed and
            # the next replay's, which must hold on its own, is checked.
            out["profiled_replay_short"] = {**window, "launches": {
                "/".join(keys): n for keys, n in profiled.items() if n}}
            profiled, window = profiled_launches(lambda: chained(GRAPH_STEPS + GRAPH_K, gen))
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
    same directory resumes after epoch 1 and runs epoch 2 alone.  The
    driver's loader gathers through the native core: its calls are counted."""
    import math

    from mmearth_tpu_torch import main_pretrain
    from mmearth_tpu_torch.checkpoints import pth_io
    from mmearth_tpu_torch.data import native

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
        gathers = native.CALLS["gather_rows"]
        _, history, opt = main_pretrain.main(args)
        launches = read_launches()
        gathers = native.CALLS["gather_rows"] - gathers
        losses = [x for e in history for x in e["step_losses"]]
        # a native call a field a batch: every batch of the run (the first
        # probe's included) went through the core
        if gathers < 12 * sum(e["steps"] for e in history):
            raise AssertionError(f"main_pretrain under graph: {gathers} native gathers")
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
                                      "optimizer_count": opt.count, "gather": "native",
                                      "native_gather_calls": gathers}
    result["kept"] = [e for e, _ in pth_io.numbered_checkpoints(out_dir)]
    if result["kept"] != [1, 2]:
        raise AssertionError(f"main_pretrain under graph: checkpoints kept {result['kept']}")
    result["seconds"] = round(time.time() - t0, 2)
    emit(result)
    return result


BENCH_LINES = {  # config -> (metric, keys its line must carry past the common ones)
    "atto56": ("mpmae_atto_mmearth64_pretrain_samples_per_sec_per_chip",
               ("block_impl", "auto_value", "eager_value", "auto_mfu", "eager_mfu")),
    "seg": ("geobench_seg_finetune_unet_atto112_img_per_sec_per_chip", ()),
}


def phase_bench(card: str, config: str = "atto56") -> dict:
    """``scripts/torch_bench.py --config config`` short (2 rounds of 10
    steps) as a user runs it, reusing the kernels built in
    ``build/kernels``: its last line is the result, for the card this smoke
    test runs on."""
    t0 = time.time()
    r = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_bench.py"), "--config",
                        config, "--rounds", "2", "--steps", "10"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if r.returncode != 0:
        raise AssertionError(f"torch_bench.py exited {r.returncode}: {last}\n{r.stderr[-3000:]}")
    line = json.loads(last)
    metric, extra = BENCH_LINES[config]
    want = {"metric", "value", "unit", "ms_per_step", "peak_mem_gib", "card", "mfu",
            "step_gflops_per_sample", *extra}
    if not (want <= set(line) and line["value"] > 0 and line["card"] == card
            and all(line[k] > 0 for k in extra if k.endswith("value"))
            and all(0 < line[k] < 1 for k in want if k.endswith("mfu"))
            and line["metric"] == metric):
        raise AssertionError(f"torch_bench.py line: {line}")
    emit({"phase": "bench", "config": config, "seconds": round(time.time() - t0, 2), **line})
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
                   probe: bool, config: tuple = ATTO56, options: dict | None = None) -> dict:
    """The GEO-Bench classification recipe (TRAINING.md) from the pretraining
    checkpoint, with ``config``'s model, input and patch size and the
    encoder ``options`` as flags: finetune, or the linear probe.  Finite
    losses, accuracies in [0, 1], 12 dW launches a step (none under the
    probe, whose trunk is frozen) and no other launch.  With the original
    stem, the classifier the driver bootstraps holds the checkpoint's
    ``stem_orig.*``."""
    import math

    import torch

    from mmearth_tpu_torch import main_finetune

    options = options or {}
    model_name, size, patch, _ = config
    args = main_finetune.get_args_parser().parse_args([
        "--model", model_name, "--input_size", str(size), "--patch_size", str(patch),
        "--data_set", "m-eurosat", "--finetune", str(checkpoint), "--processed_dir", str(data),
        "--batch_size", str(FT_BATCH), "--epochs", "3", "--blr", "1e-2" if probe else "2e-4",
        "--layer_decay", "0.9", "--weight_decay", "0.3", "--drop_path", "0.1",
        "--smoothing", "0.2", "--use_bf16", "True", "--seed", "0", "--device", "cuda",
        "--linear_probe", str(probe), *option_flags(options)])
    if options.get("use_orig_stem"):
        check_orig_stem_bootstrap(args, checkpoint)
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
    if not (probe or options):
        rows_out["dw_weight_grad"]["launches"] = launches["dw_weight_grad"]
    steady = history[1:]
    ms = 1e3 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)
    result = {"phase": "finetune", "mode": "linear_probe" if probe else "finetune",
              "model": model_name, "input_size": size, "patch_size": patch, "options": options,
              "steps": steps, "epochs": len(history), "launches": launches,
              "epoch_loss": [e["loss"] for e in history], "val_accuracy": scores[:-1],
              "test_accuracy": scores[-1], "ms_per_step": ms,
              "samples_per_s": FT_BATCH * 1e3 / ms,
              "eval_seconds": [e["eval_seconds"] for e in history],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "card": card}
    emit(result)
    return result


def check_orig_stem_bootstrap(args, checkpoint: Path) -> None:
    """The classifier that ``main_finetune`` builds and bootstraps from an
    original-stem pretraining checkpoint holds its ``stem_orig.*`` tensors."""
    import torch

    from mmearth_tpu_torch import main_finetune
    from mmearth_tpu_torch.checkpoints import pth_io
    from mmearth_tpu_torch.train.finetune import bootstrap, build_finetune_model

    cfg = main_finetune.config_from_args(args)
    model = build_finetune_model(cfg, 12, 10)
    bootstrap(model, checkpoint, cfg.run.seed)
    saved = pth_io.load(checkpoint)["model"]
    keys = [k for k in model.state_dict() if k.startswith("stem_orig.")]
    if len(keys) != 4 or not all(torch.equal(model.state_dict()[k], saved[f"encoder.{k}"])
                                 for k in keys):
        raise AssertionError(f"finetune bootstrap from {checkpoint}: stem_orig keys {keys} "
                             "not loaded from the checkpoint")


# --------------------------------------------------------------------------
# GEO-Bench segmentation and the ResNet baselines
# --------------------------------------------------------------------------
ATTO112 = ("convnextv2_atto", 112, 16, PICO_N)  # a pretraining checkpoint whose stem fits 112/16


def phase_seg_data() -> tuple[Path, Path]:
    """Synthetic packed m-cashew-plant (256/64/64, 12 bands), written anew:
    112-px tiles for the U-Net recipe and 64-px ones for the ResNet-UNet,
    whose input sides must be multiples of 32."""
    from mmearth_tpu_torch.data.geobench import generate_synthetic_geobench

    t0 = time.time()
    dirs = []
    for name, size in (("smoke_geobench_seg", 112), ("smoke_geobench_seg64", 64)):
        data = ROOT / "build" / name
        shutil.rmtree(data, ignore_errors=True)
        generate_synthetic_geobench(data, "m-cashew-plant", (256, 64, 64), seed=0, size=size)
        dirs.append(data)
    emit({"phase": "seg_data", "seconds": round(time.time() - t0, 2),
          "paths": [str(d) for d in dirs]})
    return dirs[0], dirs[1]


def seg_args(data: Path, checkpoint: Path, model: str = "convnextv2_unet_atto",
             size: int = 112, patch: int = 16):
    from mmearth_tpu_torch import main_finetune

    return main_finetune.get_args_parser().parse_args([
        "--model", model, "--input_size", str(size), "--patch_size", str(patch),
        "--data_set", "m-cashew-plant", "--finetune", str(checkpoint),
        "--processed_dir", str(data), "--batch_size", str(SEG_BATCH), "--epochs", "3",
        "--blr", "2e-4", "--layer_decay", "0.9", "--weight_decay", "0.3", "--drop_path", "0.1",
        "--smoothing", "0.0", "--use_bf16", "True", "--seed", "0", "--device", "cuda",
        "--linear_probe", "True"])


def check_seg_run(what: str, out: dict, per_epoch_dw: list[int]) -> list[dict]:
    """Every epoch's losses finite, its Jaccard and the test's in [0, 1], and
    its training steps' launches: the dense dW ``per_epoch_dw[e]`` a step,
    every other kernel none.  Returns the epochs' summaries."""
    import math

    history = out["history"]
    scores = [e["val_Jaccard"] for e in history] + [out["test_Jaccard"]]
    if not all(isinstance(v, float) and 0.0 <= v <= 1.0 for v in scores):
        raise AssertionError(f"{what}: Jaccard {scores}")
    rows = []
    for e, dw in zip(history, per_epoch_dw, strict=True):
        if not (e["steps"] > 0 and all(map(math.isfinite, e["step_losses"]))):
            raise AssertionError(f"{what}, epoch {e['epoch']}: losses {e['step_losses']}")
        for name, n in e["launches"].items():
            want = dw * e["steps"] if name == "dw_weight_grad" else 0
            if n != want:
                raise AssertionError(f"{what}, epoch {e['epoch']}, {name}: {n} launches in "
                                     f"{e['steps']} steps, expected {want}")
        rows.append({"epoch": e["epoch"], "steps": e["steps"], "loss": e["loss"],
                     "val_jaccard": e["val_Jaccard"], "lr": e["lr"],
                     "ms_per_step": 1e3 * e["seconds"] / e["steps"],
                     "dw_launches_per_step": e["launches"]["dw_weight_grad"] / e["steps"]})
    return rows


def phase_seg(rows_out: dict, card: str, data: Path, checkpoint: Path) -> dict:
    """The segmentation recipe (bench.py:507-529) through the CLI's config and
    ``run_finetune``: ``convnextv2_unet_atto`` at 112/16 (stem stride 2,
    encoder grids 56/28/14/7), batch 16, bf16, the linear probe unfrozen at
    epoch 1 of 3 (``FinetuneConfig.unfreeze_epoch``, which has no flag),
    bootstrapped from the atto 112/16 pretraining checkpoint, whose trunk the
    U-Net must hold.  Row 11 launches 0 times a step in the probe epoch and
    12 (the encoder's Blocks) after the unfreeze; no other kernel runs."""
    import dataclasses

    import torch

    from mmearth_tpu_torch import main_finetune
    from mmearth_tpu_torch.checkpoints import pth_io
    from mmearth_tpu_torch.train.finetune import bootstrap, build_finetune_model, run_finetune

    cfg = dataclasses.replace(main_finetune.config_from_args(seg_args(data, checkpoint)),
                              unfreeze_epoch=1)
    model = build_finetune_model(cfg, 12, 7)
    bootstrap(model, checkpoint, cfg.run.seed)
    saved, held = pth_io.load(checkpoint)["model"], model.state_dict()
    trunk = [k for k in held if k.startswith(("initial_conv.", "stem.", "downsample_layers.",
                                              "stages."))]
    # 8 stem tensors, 12 of the downsamples, 10 a Block
    if len(trunk) != 8 + 12 + 10 * sum(model.depths) or not all(
            torch.equal(held[k], saved[f"encoder.{k}"].reshape(held[k].shape)) for k in trunk):
        raise AssertionError(f"seg bootstrap from {checkpoint}: the U-Net does not hold its trunk")
    t0 = time.time()
    torch.cuda.reset_peak_memory_stats()
    out = run_finetune(cfg, device="cuda")
    epochs = check_seg_run("seg probe", out, [0, 12, 12])
    dw = sum(e["launches"]["dw_weight_grad"] for e in out["history"])
    rows_out["dw_weight_grad"]["seg"]["launches"] = dw
    result = {"phase": "seg", "model": cfg.model.model, "input_size": 112, "patch_size": 16,
              "batch": SEG_BATCH, "unfreeze_epoch": cfg.unfreeze_epoch, "epochs": epochs,
              "trunk_tensors_held": len(trunk), "dw_launches": dw,
              "test_jaccard": out["test_Jaccard"],
              "probe_ms_per_step": epochs[0]["ms_per_step"],
              "unfrozen_ms_per_step": epochs[2]["ms_per_step"],
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "seconds": round(time.time() - t0, 2), "card": card}
    emit(result)
    return result


def random_resnet18_state() -> dict:
    """A random 12-band ResNet-18 backbone under torchvision's keys (``fc``
    left out), BN statistics drawn too."""
    import torch

    from mmearth_tpu_torch.models.resnet import build_resnet

    gen = torch.Generator().manual_seed(5)
    sd = build_resnet("resnet18", num_classes=10, in_chans=12).init_weights(gen).state_dict()
    out = {}
    for k, v in sd.items():
        if k.startswith("fc."):
            continue
        if k.endswith(("running_var", "bn2.weight")):  # positive; bn2's init is zero
            v = torch.rand(v.shape, generator=gen) + 0.5
        elif v.is_floating_point():
            v = v + 0.1 * torch.randn(v.shape, generator=gen)
        out[k] = v
    return out


def phase_baselines(card: str, eurosat: Path, cashew64: Path) -> list[dict]:
    """The ResNet baselines through ``main_finetune.main`` from foreign
    files written here: ``resnet18`` finetuned on m-eurosat (3 epochs,
    batch 32) from a SeCo-style ``.pth`` (MoCo ``encoder_q.`` keys and
    momentum-encoder and queue entries that the remap drops), and
    ``resnet18_unet`` as the probe on 64-px m-cashew-plant (3 epochs, batch
    16) from a Satlas-style one (foreign key names, renamed by position).
    Each bootstrapped model holds the file's backbone; losses are finite,
    scores in [0, 1], and no kernel of the port runs."""
    import math

    import torch

    from mmearth_tpu_torch import main_finetune
    from mmearth_tpu_torch.train.finetune import bootstrap, build_finetune_model

    foreign = ROOT / "build" / "smoke_foreign"
    shutil.rmtree(foreign, ignore_errors=True)
    foreign.mkdir(parents=True)
    backbone = random_resnet18_state()
    seco = {f"encoder_q.{k}": v for k, v in backbone.items()}
    seco.update({"encoder_k.conv1.weight": torch.zeros(64, 12, 7, 7), "queue": torch.zeros(128, 8),
                 "queue_ptr": torch.zeros((), dtype=torch.long)})
    torch.save({"state_dict": seco}, foreign / "seco_resnet18.pth")
    torch.save({f"backbone.body.{i}": v for i, v in enumerate(backbone.values())},
               foreign / "satlas_resnet18.pth")
    results = []
    for model_name, data_set, data, path, probe, batch in (
            ("resnet18", "m-eurosat", eurosat, foreign / "seco_resnet18.pth", False, FT_BATCH),
            ("resnet18_unet", "m-cashew-plant", cashew64, foreign / "satlas_resnet18.pth", True,
             SEG_BATCH)):
        args = main_finetune.get_args_parser().parse_args([
            "--model", model_name, "--data_set", data_set, "--finetune", str(path),
            "--processed_dir", str(data), "--batch_size", str(batch), "--epochs", "3",
            "--blr", "2e-4", "--layer_decay", "0.9", "--weight_decay", "0.3",
            "--smoothing", "0.0", "--use_bf16", "True", "--seed", "0", "--device", "cuda",
            "--linear_probe", str(probe)])
        cfg = main_finetune.config_from_args(args)
        model = build_finetune_model(cfg, 12, 10 if data_set == "m-eurosat" else 7)
        bootstrap(model, path, cfg.run.seed)
        prefix = "encoder." if probe else ""
        held = model.state_dict()
        if not all(torch.equal(held[prefix + k], v.to(held[prefix + k].dtype))
                   for k, v in backbone.items()):
            raise AssertionError(f"{model_name} from {path.name}: the backbone is not the file's")
        t0 = time.time()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out = main_finetune.main(args)
        metric = "Jaccard" if probe else "Accuracy"
        history = out["history"]
        scores = [e[f"val_{metric}"] for e in history] + [out[f"test_{metric}"]]
        losses = [x for e in history for x in e["step_losses"]]
        if (not losses or not all(map(math.isfinite, losses))
                or not all(isinstance(v, float) and 0.0 <= v <= 1.0 for v in scores)):
            raise AssertionError(f"{model_name}: losses {losses}, {metric} {scores}")
        if any(read_launches().values()):
            raise AssertionError(f"{model_name}: launched {read_launches()}")
        steady = history[1:]
        result = {"phase": "baseline", "model": model_name, "data_set": data_set,
                  "finetune": path.name, "mode": "linear_probe" if probe else "finetune",
                  "steps": len(losses), "epoch_loss": [e["loss"] for e in history],
                  f"val_{metric.lower()}": scores[:-1], f"test_{metric.lower()}": scores[-1],
                  "ms_per_step": 1e3 * sum(e["seconds"] for e in steady)
                  / sum(e["steps"] for e in steady),
                  "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                  "seconds": round(time.time() - t0, 2), "card": card}
        emit(result)
        results.append(result)
    return results


OPT_FAMILIES = ("adamw", "adam", "nadam", "radam", "sgd", "nesterov", "momentum", "adadelta",
                "adafactor", "rmsprop", "rmsproptf", "novograd", "nvnovograd", "lamb")
FAMILY_LR, FAMILY_STEPS = 1e-4, 3


def phase_families(card: str) -> list[dict]:
    """Every ``--opt`` family: 3 f32 finetune steps (TF32 off, drop path 0)
    of the small dense classifier of ``phase_reference_classifier`` on the
    GPU (row 11 in its 4 Blocks a step) against the same steps on the CPU,
    at that phase's tolerances: each step's loss within 1e-4 relative, and
    every param within 1e-3 of the model's largest (the lr, 1e-4, bounds
    what an update moves a param, so a gradient that rounds to the other
    sign near 0 moves the params by less than that); ms a step on the GPU
    (the last two steps)."""
    import torch

    from mmearth_tpu_torch.losses.finetune import criterion_fn
    from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
    from mmearth_tpu_torch.train.finetune import finetune_step
    from mmearth_tpu_torch.train.optim import Optimizer, finetune_wd_mask

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(depths=(1, 1, 1, 1), dims=(16, 32, 48, 64), sparse=False, num_classes=10,
              head_init_scale=1.0)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(4, 64, 64, 12, generator=gen)
    y = torch.randint(0, 10, (4,), generator=gen)
    criterion = criterion_fn("m-eurosat", 0.2)
    rows = []
    for name in OPT_FAMILIES:
        runs = {}
        for dev in ("cpu", "cuda"):
            model = ConvNeXtV2(**kw)
            model.init_weights(torch.Generator().manual_seed(1))
            model.to(dev)
            named = list(model.named_parameters())
            opt = Optimizer(named, lambda n: FAMILY_LR, 0.05, (0.9, 0.999),
                            wd_mask=finetune_wd_mask(named), opt=name)
            batch = {"input": x.to(dev), "label": y.to(dev)}
            draws = torch.Generator(device=dev).manual_seed(0)
            reset_launches()
            losses, ms = [], []
            for _ in range(FAMILY_STEPS):
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(float(finetune_step(model, opt, batch, criterion, draws)))
                if dev == "cuda":
                    torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            runs[dev] = (losses, {k: p.detach().cpu() for k, p in model.named_parameters()},
                         read_launches()["dw_weight_grad"], ms)
        (l_cpu, p_cpu, _, _), (l_gpu, p_gpu, launches, ms) = runs["cpu"], runs["cuda"]
        loss_rel = max(abs(a - b) / abs(a) for a, b in zip(l_cpu, l_gpu))
        scale = max(float(t.abs().max()) for t in p_cpu.values())
        worst = max(float((p_gpu[k] - p_cpu[k]).abs().max()) for k in p_cpu) / scale
        row = {"phase": "opt_family", "opt": name, "steps": FAMILY_STEPS,
               "loss_cpu": l_cpu, "loss_gpu": l_gpu, "loss_rel": loss_rel,
               "worst_param_rel": worst, "dw_weight_grad_launches": launches,
               "ms_per_step": statistics.mean(ms[1:]), "card": card}
        emit(row)
        if not (loss_rel < 1e-4 and worst < 1e-3 and launches == 4 * FAMILY_STEPS):
            raise AssertionError(f"--opt {name}: GPU against CPU {row}")
        rows.append(row)
    return rows


def phase_finetune_lamb(card: str, checkpoint: Path) -> dict:
    """``main_finetune --opt lamb`` at the finetune recipe (the dense atto
    classifier at 112/16, batch 32, bf16) from the atto 112/16 pretraining
    slice's checkpoint on 112-px synthetic m-eurosat (128/32/32) into
    ``build/smoke_lamb_out``: 2 epochs with 12 row-11 launches a step and no
    other, then ``--epochs 3`` on the same directory resumes and runs epoch
    2 alone under the restored LAMB state."""
    import math

    from mmearth_tpu_torch import main_finetune
    from mmearth_tpu_torch.data.geobench import generate_synthetic_geobench

    data, out_dir = ROOT / "build" / "smoke_geobench112", ROOT / "build" / "smoke_lamb_out"
    for d in (data, out_dir):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.time()
    generate_synthetic_geobench(data, "m-eurosat", (128, 32, 32), seed=0, size=112)
    result = {"phase": "finetune_lamb", "checkpoint": str(checkpoint.relative_to(ROOT)),
              "card": card}
    for epochs, want in ((2, [0, 1]), (3, [2])):
        args = main_finetune.get_args_parser().parse_args([
            "--model", "convnextv2_atto", "--input_size", "112", "--patch_size", "16",
            "--data_set", "m-eurosat", "--finetune", str(checkpoint), "--processed_dir",
            str(data), "--batch_size", str(FT_BATCH), "--epochs", str(epochs), "--blr", "2e-4",
            "--layer_decay", "0.9", "--weight_decay", "0.3", "--drop_path", "0.1",
            "--smoothing", "0.2", "--use_bf16", "True", "--seed", "0", "--device", "cuda",
            "--opt", "lamb", "--output_dir", str(out_dir)])
        reset_launches()
        out = main_finetune.main(args)
        launches = read_launches()
        history = out["history"]
        steps = sum(e["steps"] for e in history)
        losses = [x for e in history for x in e["step_losses"]]
        if [e["epoch"] for e in history] != want or not all(map(math.isfinite, losses)):
            raise AssertionError(f"--opt lamb, --epochs {epochs}: epochs "
                                 f"{[e['epoch'] for e in history]}, losses {losses}")
        for name, n in launches.items():
            if n != (12 * steps if name == "dw_weight_grad" else 0):
                raise AssertionError(f"--opt lamb: {name} launched {n} times in {steps} steps")
        opt = out["optimizer"]
        if opt.opt != "lamb" or opt.count != 4 * epochs:
            raise AssertionError(f"--opt lamb: optimizer {opt.opt} at {opt.count} updates")
        result[f"epochs_{epochs}"] = {"epochs": want, "steps": steps, "launches": launches,
                                      "epoch_loss": [e["loss"] for e in history],
                                      "val_accuracy": [e["val_Accuracy"] for e in history],
                                      "ms_per_step": 1e3 * sum(e["seconds"] for e in history)
                                      / steps}
    result["seconds"] = round(time.time() - t0, 2)
    emit(result)
    return result


# the packages the drivers import only on their paths, and the flags whose
# paths need them
ORBAX_FIXTURE = ROOT / "tests" / "fixtures" / "orbax_pretrain_tiny"


def orbax_flags(cfg: dict, data: Path, device: str, *extra) -> list[str]:
    """``main_pretrain`` flags of the Orbax fixture's model (its narrow size
    registered as ``--model convnextv2_<model_size>``), f32, wholeblock."""
    return ["--model", f"convnextv2_{cfg['model_size']}", "--input_size", str(cfg["img_size"]),
            "--patch_size", str(cfg["patch_size"]),
            "--decoder_embed_dim", str(cfg["decoder_embed_dim"]),
            "--batch_size", str(cfg["batch_size"]), "--update_freq", str(cfg["update_freq"]),
            "--use_bf16", "False", "--device", device, "--block_impl", "wholeblock",
            "--sparse_impl", "gathered", "--seed", "0", "--processed_dir", str(data),
            "--warmup_epochs", "1", *extra]


def orbax_leaves(record: dict, tree) -> int:
    """Every leaf the reader gives against the fixture's recorded dtype,
    shape and sha256; returns the count."""
    import hashlib

    import numpy as np
    import torch

    from mmearth_tpu_torch.checkpoints.convert import tree_leaves

    got = {".".join(map(str, p)): leaf for p, leaf in tree_leaves(tree) if leaf is not None}
    if set(got) != set(record["leaves"]):
        raise AssertionError(f"orbax: leaves {sorted(set(got) ^ set(record['leaves']))[:5]} "
                             "differ from the fixture's record")
    for name, (dtype, shape, digest) in record["leaves"].items():
        leaf = got[name]
        bits = leaf.view(torch.int16).numpy() if isinstance(leaf, torch.Tensor) else leaf
        mine = ("bfloat16" if isinstance(leaf, torch.Tensor) else str(leaf.dtype),
                list(np.shape(leaf)),
                hashlib.sha256(np.ascontiguousarray(bits).tobytes()).hexdigest())
        if mine != (dtype, shape, digest):
            raise AssertionError(f"orbax: leaf {name} reads as {mine[:2]}, sha256 {mine[2][:12]}; "
                                 f"the fixture holds {dtype} {shape}, {digest[:12]}")
    return len(got)


def orbax_resumed_steps(record: dict, args) -> dict:
    """The driver's model and ``pretrain.resume`` on the fixture's step
    (``--resume``), with JAX's AdamW settings (clip on), f32, TF32 off: the
    encoder's output and the next two micro-steps' losses on the fixture's
    batches and masks against JAX's, each Block's kernels launched."""
    import base64
    import hashlib

    import numpy as np
    import torch

    from mmearth_tpu_torch.data.synthetic import bench_batch
    from mmearth_tpu_torch.main_pretrain import config_from_args
    from mmearth_tpu_torch.models.fcmae import zero_nan_inputs
    from mmearth_tpu_torch.train import pretrain
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.schedule import warmup_cosine
    from mmearth_tpu_torch.train.step import pretrain_step

    cfg = record["config"]
    conf = config_from_args(args)
    dev = torch.device(args.device)
    model = pretrain.build_model(conf, dev)
    opt = AdamW(model.named_parameters(), warmup_cosine(*cfg["schedule"]), cfg["weight_decay"],
                tuple(cfg["betas"]), update_freq=cfg["update_freq"], clip_grad=cfg["clip_grad"])
    if pretrain.resume(conf.run, model, opt, None) != cfg["epoch"] + 1:
        raise AssertionError("orbax: the resume did not continue after the fixture's epoch")
    n, saved, after = cfg["batch_size"], cfg["micro_steps_saved"], cfg["micro_steps_after"]
    data = bench_batch(n * (saved + after), cfg["img_size"], seed=cfg["batch_seed"])
    out = {"losses": [], "losses_jax": record["losses_after"]}
    gen = torch.Generator(device=dev).manual_seed(0)
    batches, masks = [], []
    for i in range(saved, saved + after):
        host = {k: v[i * n:(i + 1) * n] for k, v in data.items()}
        h = hashlib.sha256()
        for k in sorted(host):
            h.update(k.encode())
            h.update(np.ascontiguousarray(host[k]).tobytes())
        if h.hexdigest() != record["batch_sha256"][i]:
            raise AssertionError(f"orbax: batch {i} differs from the one JAX's losses are of "
                                 "(numpy's bench_batch stream changed)")
        batches.append({k: torch.from_numpy(v).to(dev) for k, v in host.items()})
        masks.append(torch.tensor([[float(c) for c in row] for row in record["masks"][i]],
                                  device=dev))
    enc = record["encoder_output"]
    want = np.frombuffer(base64.b64decode(enc["f32_base64"]), "<f4").reshape(enc["shape"])
    with torch.no_grad():
        imgs = zero_nan_inputs(batches[0])["sentinel2"]
        got = model.encoder.encode(imgs, masks[0], model.num_visible).float().cpu().numpy()
    out["encoder_max_abs_err"] = float(np.abs(got - want).max())
    out["encoder_scale"] = float(np.abs(want).max())
    if not out["encoder_max_abs_err"] <= 1e-4 * out["encoder_scale"]:
        raise AssertionError(f"orbax: encoder output {out['encoder_max_abs_err']:.3e} "
                             f"from JAX's (scale {out['encoder_scale']:.3e})")
    reset_launches()
    for i, (batch, mask) in enumerate(zip(batches, masks), start=saved):
        metrics = pretrain_step(model, opt, batch, i, gen, random_crop=False, mask=mask)
        out["losses"].append(float(metrics["loss"]))
    out["launches"] = read_launches()
    out["loss_rel"] = [abs(a - b) / abs(b) for a, b in zip(out["losses"], out["losses_jax"])]
    # f32 on both sides, the card's kernels against JAX's XLA on the CPU:
    # summation order only, the existing f32 card-vs-CPU phases' 1e-4
    if not max(out["loss_rel"]) < 1e-4:
        raise AssertionError(f"orbax: resumed losses {out['losses']} against JAX's "
                             f"{out['losses_jax']}")
    if opt.count != 2 or opt.mini_step != 1:
        raise AssertionError(f"orbax: AdamW at count {opt.count}, micro-step {opt.mini_step}")
    return out


def orbax_writer():
    """``scripts/torch_to_orbax.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_to_orbax",
                                                  ROOT / "scripts" / "torch_to_orbax.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def orbax_write(pth: Path, out: Path) -> tuple[Path, dict]:
    """The port's ``.pth`` at ``pth`` written as an Orbax step under
    ``out`` (``torch_to_orbax.convert``): the step and the write's bytes,
    seconds and rate on the card's host."""
    shutil.rmtree(out, ignore_errors=True)
    [rec] = orbax_writer().convert(pth, out)
    return Path(rec["wrote"]), {
        "bytes": rec["bytes"], "write_seconds": rec["write_seconds"],
        "write_mb_per_s": rec["bytes"] / rec["write_seconds"] / 1e6,
        "convert_seconds": rec["seconds"], "host": "the card's host CPU"}


def orbax_same_state(what: str, model, opt, saved: dict) -> int:
    """``model`` and ``opt`` hold the ``.pth``'s ``saved`` state bit for
    bit; returns the tensors compared."""
    import torch

    held, mine = model.state_dict(), opt.state_dict()
    pairs = [(k, held[k], v) for k, v in saved["model"].items()]
    for key, theirs in saved["optimizer"].items():
        if isinstance(theirs, dict):
            pairs += [(f"{key}.{n}", mine[key][n], t) for n, t in theirs.items()]
        elif theirs != mine[key]:
            raise AssertionError(f"{what}: optimizer {key} {mine[key]}, the .pth holds {theirs}")
    bad = [k for k, a, b in pairs if a.dtype != b.dtype or not torch.equal(a.cpu(), b)]
    if bad:
        raise AssertionError(f"{what}: {bad[:5]} differ from the .pth")
    return len(pairs)


def orbax_round_trip(record: dict, args, pth: Path) -> dict:
    """(6) The ``.pth`` ``main_pretrain --resume <fixture>`` wrote, as an
    Orbax step (the port's writer), read back by the port's reader and
    ``pretrain.resume`` on ``cuda`` (f32, TF32 off, ``wholeblock``), and the
    ``.pth`` itself resumed the same way: both states bit-equal to the
    ``.pth``'s, then the next micro-step of each on the fixture's batch and
    mask, its kernels launched at ``expected_launches``' counts and the
    two losses equal."""
    import numpy as np
    import torch

    from mmearth_tpu_torch.checkpoints import orbax_io, pth_io
    from mmearth_tpu_torch.configs.config import RunConfig
    from mmearth_tpu_torch.data.synthetic import bench_batch
    from mmearth_tpu_torch.main_pretrain import config_from_args
    from mmearth_tpu_torch.train import pretrain
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.schedule import warmup_cosine
    from mmearth_tpu_torch.train.step import pretrain_step

    cfg = record["config"]
    step, out = orbax_write(pth, ROOT / "build" / "smoke_orbax_write")
    saved = pth_io.load(pth)
    conf = config_from_args(args)
    dev = torch.device("cuda")
    per_step, _ = expected_launches("gathered", "wholeblock", (args.model, args.input_size,
                                                                args.patch_size, args.batch_size))
    i = cfg["micro_steps_saved"]
    n = cfg["batch_size"]
    host = {k: v[i * n:(i + 1) * n] for k, v in bench_batch(
        n * (i + 1), cfg["img_size"], seed=cfg["batch_seed"]).items()}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    mask = torch.tensor(np.array([[float(c) for c in row] for row in record["masks"][i]],
                                 np.float32), device=dev)
    for src in ("orbax", "pth"):
        model = pretrain.build_model(conf, dev)
        opt = AdamW(model.named_parameters(), warmup_cosine(*cfg["schedule"]),
                    conf.optim.weight_decay, conf.optim.betas,
                    update_freq=conf.optim.update_freq, clip_grad=conf.optim.clip_grad)
        orbax_io.ReadStats.reset()
        path = step if src == "orbax" else pth
        if pretrain.resume(RunConfig(resume=str(path)), model, opt, None) != saved["epoch"] + 1:
            raise AssertionError(f"orbax round trip: {path} did not resume after epoch "
                                 f"{saved['epoch']}")
        if src == "orbax":
            sec = orbax_io.ReadStats.seconds
            out.update(read_seconds=sec, read_bytes=orbax_io.ReadStats.bytes_read,
                       read_mb_per_s=orbax_io.ReadStats.bytes_read / sec / 1e6)
        out[f"{src}_tensors_equal"] = orbax_same_state(f"orbax round trip ({src})", model, opt,
                                                       saved)
        reset_launches()
        loss = pretrain_step(model, opt, batch, int(saved["epoch"]) + 1, torch.Generator(
            device=dev).manual_seed(0), random_crop=False, mask=mask)["loss"]
        out[f"{src}_loss"] = float(loss)
        check_launches(f"orbax round trip ({src})", read_launches(), per_step, 1)
    out["loss_rel"] = abs(out["orbax_loss"] - out["pth_loss"]) / abs(out["pth_loss"])
    # the same state and batch through the same kernels; the forward's
    # column sums of squares (GRN) are atomicAdds across blocks, whose order
    # may move the f32 loss by a few ulps
    if not out["loss_rel"] <= 1e-6:
        raise AssertionError(f"orbax round trip: the step's loss {out['orbax_loss']}, the "
                             f".pth's {out['pth_loss']}")
    return out


def orbax_full_width(pth: Path) -> dict:
    """(7) The atto56 ``wholeblock`` slice's ``checkpoint-2.pth`` (bf16 run,
    f32 params and AdamW slots) written as an Orbax step and read back by
    the port's reader: every tensor bit-equal to the ``.pth``'s, and the
    write's and the read's seconds and rates on the card's host."""
    from mmearth_tpu_torch.checkpoints import convert, orbax_io, pth_io

    step, out = orbax_write(pth, ROOT / "build" / "smoke_orbax_full")
    orbax_io.ReadStats.reset()
    tree = orbax_io.load_tree(step)
    sec = orbax_io.ReadStats.seconds
    out.update(read_seconds=sec, read_bytes=orbax_io.ReadStats.bytes_read,
               read_mb_per_s=orbax_io.ReadStats.bytes_read / sec / 1e6)
    saved = pth_io.load(pth)
    model, opt, _ = orbax_writer().rebuild(saved)
    model.load_state_dict(orbax_io.port_state(tree, model))
    params = orbax_io.numpy_tree(tree["params"])
    opt.load_state_dict(convert.from_jax_opt_state(orbax_io.numpy_tree(tree["opt_state"]), opt,
                                                   params, convert.params_converter(model)))
    out["tensors_equal"] = orbax_same_state("orbax full width", model, opt, saved)
    out["step"] = int(tree["step"])
    return out


def phase_orbax(card: str, geobench: Path, full_width_pth: Path) -> dict:
    """The JAX package's Orbax checkpoint on the card (the committed fixture
    ``tests/fixtures/orbax_pretrain_tiny``, written by
    ``tests/_torch_orbax_fixture.py``: a narrow FCMAE saved by JAX's
    ``CheckpointIO`` after 3 micro-steps at ``update_freq`` 2, clip on).
    (1) Every leaf the reader gives matches its recorded checksum; the
    reader's host seconds and rates.  (2) ``pretrain.resume`` (the driver's)
    on the ``main_pretrain`` flags' model, f32, TF32 off, ``wholeblock``: the
    encoder's output and the next two micro-steps' losses against JAX's.
    (3) ``main_pretrain --resume <step>`` for one epoch, rows 1-4 and 7-11
    launched as the slice's counts say, then ``checkpoint-1.pth`` written.
    (4) ``main_finetune --finetune <step>`` for one epoch on the smoke
    GEO-Bench pack, row 11 launched.  (5) ``hub.MPMAE(ckpt_path=<step>)`` on
    ``cuda`` holds the reader's encoder and gives finite logits.  (6) The
    port's writer: (3)'s ``checkpoint-1.pth`` as an Orbax step, read back
    and resumed (``orbax_round_trip``).  (7) The atto56 slice's
    ``full_width_pth`` written and read back (``orbax_full_width``)."""
    import json
    import math

    import numpy as np
    import torch

    from mmearth_tpu_torch import hub, main_finetune, main_pretrain
    from mmearth_tpu_torch.checkpoints import orbax_io, pth_io
    from mmearth_tpu_torch.checkpoints import load_pretrained as lp
    from mmearth_tpu_torch.configs import config as tconfig

    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    record = json.loads((ORBAX_FIXTURE / "expected.json").read_text())
    cfg = record["config"]
    step_dir = ORBAX_FIXTURE / "checkpoints" / str(cfg["epoch"])
    tconfig.MODEL_SIZES[cfg["model_size"]] = (tuple(cfg["depths"]), tuple(cfg["dims"]))
    result = {"phase": "orbax", "card": card, "fixture": str(ORBAX_FIXTURE.relative_to(ROOT))}
    # (1) the reader
    reads = []
    for _ in range(3):
        orbax_io.ReadStats.reset()
        tree = orbax_io.load_tree(step_dir)
        reads.append((orbax_io.ReadStats.seconds, orbax_io.ReadStats.bytes_read,
                      orbax_io.ReadStats.array_bytes))
    result["leaves"] = orbax_leaves(record, tree)
    sec, nbytes, abytes = reads[0]
    best = min(r[0] for r in reads)
    result["read"] = {"seconds_first": sec, "seconds_best_of_3": best, "store_bytes": nbytes,
                      "array_bytes": abytes, "store_mb_per_s_first": nbytes / sec / 1e6,
                      "store_mb_per_s_best": nbytes / best / 1e6,
                      "array_mb_per_s_best": abytes / best / 1e6, "host": "the card's host CPU"}
    # (2) the resumed steps against JAX's
    data = phase_data("smoke_orbax_data", n=17, tile=64)
    out_dir = ROOT / "build" / "smoke_orbax_out"
    shutil.rmtree(out_dir, ignore_errors=True)
    args = main_pretrain.get_args_parser().parse_args(orbax_flags(
        cfg, data, "cuda", "--resume", str(step_dir), "--epochs", str(cfg["epoch"] + 2),
        "--output_dir", str(out_dir)))
    t0 = time.perf_counter()
    steps = orbax_resumed_steps(record, args)
    per_step, _ = expected_launches("gathered", "wholeblock",
                                    (args.model, args.input_size, args.patch_size,
                                     args.batch_size))
    check_launches("orbax resumed steps", steps["launches"], per_step,
                   cfg["micro_steps_after"])
    steps["seconds"] = time.perf_counter() - t0
    result["resumed_steps"] = steps
    # (3) main_pretrain --resume <step>
    t0 = time.perf_counter()
    reset_launches()
    _, history, opt = main_pretrain.main(args)
    launches = read_launches()
    n_steps = sum(e["steps"] for e in history)
    losses = [x for e in history for x in e["step_losses"]]
    if [e["epoch"] for e in history] != [cfg["epoch"] + 1] or n_steps < 2 or not all(
            map(math.isfinite, losses)):
        raise AssertionError(f"orbax: main_pretrain resumed epochs {history}")
    check_launches("orbax main_pretrain --resume", launches, per_step, n_steps)
    if [e for e, _ in pth_io.numbered_checkpoints(out_dir)] != [cfg["epoch"] + 1]:
        raise AssertionError(f"orbax: {out_dir} holds {pth_io.numbered_checkpoints(out_dir)}")
    result["main_pretrain"] = {"steps": n_steps, "losses": losses, "launches": launches,
                               "count": opt.count, "mini_step": opt.mini_step,
                               "seconds": time.perf_counter() - t0}
    # (4) main_finetune --finetune <step>
    t0 = time.perf_counter()
    ft = main_finetune.get_args_parser().parse_args([
        "--model", f"convnextv2_{cfg['model_size']}", "--input_size", str(cfg["img_size"]),
        "--patch_size", str(cfg["patch_size"]), "--data_set", "m-eurosat",
        "--finetune", str(step_dir), "--processed_dir", str(geobench),
        "--batch_size", str(FT_BATCH), "--epochs", "1", "--use_bf16", "False", "--seed", "0",
        "--device", "cuda"])
    reset_launches()
    ftout = main_finetune.main(ft)
    launches = read_launches()
    ft_steps = sum(e["steps"] for e in ftout["history"])
    ft_losses = [x for e in ftout["history"] for x in e["step_losses"]]
    blocks = sum(cfg["depths"])
    for name, n in launches.items():
        want = blocks * ft_steps if name == "dw_weight_grad" else 0
        if n != want:
            raise AssertionError(f"orbax finetune, {name}: {n} launches in {ft_steps} steps, "
                                 f"expected {want}")
    if not (ft_steps > 0 and all(map(math.isfinite, ft_losses))
            and 0.0 <= ftout["test_Accuracy"] <= 1.0):
        raise AssertionError(f"orbax finetune: {ft_steps} steps, losses {ft_losses}")
    result["finetune"] = {"steps": ft_steps, "epoch_loss": ftout["history"][0]["loss"],
                          "test_accuracy": ftout["test_Accuracy"], "launches": launches,
                          "seconds": time.perf_counter() - t0}
    # (5) the hub
    t0 = time.perf_counter()
    cls, _ = hub.MPMAE(model_name=f"convnextv2_{cfg['model_size']}", ckpt_path=str(step_dir),
                       device="cuda", img_size=cfg["img_size"], patch_size=cfg["patch_size"],
                       num_classes=10)
    enc = lp.encoder_state_from_checkpoint(step_dir, tuple(cfg["depths"]))
    held = cls.state_dict()
    if not all(torch.equal(held[k].cpu(), v) for k, v in enc.items()):
        raise AssertionError("orbax: the hub's classifier does not hold the checkpoint's encoder")
    x = torch.randn(2, cfg["img_size"], cfg["img_size"], 12, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(0))
    with torch.no_grad():
        logits = cls.eval()(x)
    if tuple(logits.shape) != (2, 10) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"orbax: hub logits {tuple(logits.shape)}")
    result["hub"] = {"encoder_keys": len(enc), "logits_finite": True,
                     "seconds": time.perf_counter() - t0}
    # (6) and (7) the writer
    t0 = time.perf_counter()
    result["round_trip"] = orbax_round_trip(
        record, args, out_dir / f"checkpoint-{cfg['epoch'] + 1}.pth")
    result["round_trip"]["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["full_width"] = orbax_full_width(full_width_pth)
    result["full_width"]["seconds"] = time.perf_counter() - t0
    result["seconds"] = time.perf_counter() - t_phase
    emit(result)
    return result


OPTIONAL_PACKAGES = (("h5py", ("--loader", "hdf5")), ("array_record", ("--loader", "grain")),
                     ("tensorboardX", ("--log_dir",)))


def phase_optional_packages(card: str) -> list[dict]:
    """``--loader hdf5`` (h5py), ``--loader grain`` (array_record) and
    ``--log_dir`` (tensorboardX) through ``main_pretrain.main``: where the
    package is missing the run must raise before its first step (no kernel
    launched), naming the package; where it is present, the path runs 2
    atto 56/8 steps at batch 8 on 24 synthetic samples in
    ``build/smoke_optional``."""
    import importlib.util
    import math

    from mmearth_tpu_torch import main_pretrain
    from mmearth_tpu_torch.data.loader import PackedDataset
    from mmearth_tpu_torch.data.synthetic import generate_packed

    root = ROOT / "build" / "smoke_optional"
    shutil.rmtree(root, ignore_errors=True)
    rows = []
    for package, flag in OPTIONAL_PACKAGES:
        present = importlib.util.find_spec(package) is not None
        run = root / package
        extra = [*flag, str(run / "tb")] if flag == ("--log_dir",) else [*flag]
        if present:
            if package == "h5py":
                from mmearth_tpu_torch.data.synthetic import generate

                generate(run / "h5", n=24, tile=64, seed=0)
            else:
                generate_packed(run / "proc", n=24, tile=64, seed=0, splits=("train",))
            if package == "array_record":
                from mmearth_tpu_torch.data.grain_pipeline import pack_arrayrecord

                ds = PackedDataset(run / "proc" / "train")
                items = [{"id": str(i), **{k: a[i] for k, a in ds.arrays.items()}}
                         for i in range(ds.count)]
                pack_arrayrecord(items, run / "proc" / "train_arrayrecord")
        args = slice_args("gathered", "wholeblock", run / "proc", ATTO56[:3] + (8,), *extra,
                          "--data_dir", str(run / "h5"), "--epochs", "1")
        reset_launches()
        row = {"phase": "optional_package", "package": package, "flag": " ".join(flag),
               "present": present, "card": card}
        try:
            _, history, _ = main_pretrain.main(args)
        except ImportError as e:
            if present or package not in str(e):
                raise
            if any(read_launches().values()):
                raise AssertionError(f"{package} missing: a step ran before the refusal")
            row.update(outcome="refused", message=str(e))
        else:
            if not present:
                raise AssertionError(f"{' '.join(flag)} ran without {package}")
            losses = history[0]["step_losses"]
            if history[0]["steps"] != 2 or not all(map(math.isfinite, losses)):
                raise AssertionError(f"{' '.join(flag)}: {history}")
            row.update(outcome="ran", steps=2, losses=losses)
        emit(row)
        rows.append(row)
    return rows


def phase_reference_seg() -> None:
    """Small f32 steps on the GPU against the CPU (TF32 off): the U-Net
    (depths 1/1/1/1 at atto widths, 112/16, drop path 0) through the dW
    kernel, loss and every grad within 1e-4 / 1e-3 of their scale; and
    ResNet-18 and its U-Net in train mode, loss within 1e-4, every grad
    within 1e-3 in relative L2 norm (flax's E[x^2] - E[x]^2 variance
    cancels, so a few deep channels carry more rounding), the BN running
    statistics within 1e-4 of their scale."""
    import copy

    import torch

    from mmearth_tpu_torch.losses.finetune import criterion_fn
    from mmearth_tpu_torch.models.resnet import build_resnet
    from mmearth_tpu_torch.models.unet import ConvNeXtV2Unet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    cases = (
        ("unet", ConvNeXtV2Unet(patch_size=16, img_size=112, in_chans=12, num_classes=7,
                                depths=(1, 1, 1, 1), dims=(40, 80, 160, 320), head_init_scale=1.0
                                ).init_weights(torch.Generator().manual_seed(1)),
         torch.randn(4, 112, 112, 12, generator=gen), torch.randint(0, 7, (4, 112, 112),
                                                                     generator=gen), 4),
        ("resnet18", build_resnet("resnet18", num_classes=10, in_chans=12).init_weights(
            torch.Generator().manual_seed(1)), torch.randn(8, 64, 64, 12, generator=gen),
         torch.randint(0, 10, (8,), generator=gen), 0),
        ("resnet18_unet", build_resnet("resnet18_unet", num_classes=7, in_chans=12).init_weights(
            torch.Generator().manual_seed(1)), torch.randn(4, 64, 64, 12, generator=gen),
         torch.randint(0, 7, (4, 64, 64), generator=gen), 0))
    for name, cpu, x, y, dw in cases:
        crit = criterion_fn("m-eurosat" if name == "resnet18" else "m-cashew-plant", 0.0)
        gpu = copy.deepcopy(cpu).cuda()
        reset_launches()
        out = {}
        for key, model in (("cpu", cpu), ("gpu", gpu)):
            dev = next(model.parameters()).device
            loss = crit(model(x.to(dev)), y.to(dev))
            loss.backward()
            grads = {k: p.grad.cpu() for k, p in model.named_parameters() if p.grad is not None}
            out[key] = (float(loss.detach()), grads,
                        {k: b.cpu() for k, b in model.named_buffers()})
        if read_launches()["dw_weight_grad"] != dw:
            raise AssertionError(f"{name} reference step: {read_launches()}, expected {dw} dW")
        (l_cpu, g_cpu, b_cpu), (l_gpu, g_gpu, b_gpu) = out["cpu"], out["gpu"]
        rel = abs(l_cpu - l_gpu) / abs(l_cpu)
        if name == "unet":
            worst = max(float((g_gpu[k] - g_cpu[k]).abs().max() / (g_cpu[k].abs().max() + 1e-12))
                        for k in g_cpu)
        else:
            worst = max(float((g_gpu[k] - g_cpu[k]).norm() / (g_cpu[k].norm() + 1e-12))
                        for k in g_cpu)
        stats = max((float((b_gpu[k].double() - b_cpu[k].double()).abs().max()
                           / max(float(b_cpu[k].double().abs().max()), 1.0)) for k in b_cpu),
                    default=0.0)
        if not (rel < 1e-4 and worst < 1e-3 and stats < 1e-4 and set(g_cpu) == set(g_gpu)):
            raise AssertionError(f"{name} GPU vs CPU step: loss rel {rel:.2e}, worst grad "
                                 f"{worst:.2e}, running stats {stats:.2e}")
        emit({"phase": "reference", "model": name, "loss_cpu": l_cpu, "loss_gpu": l_gpu,
              "loss_rel": rel, "worst_grad_rel": worst, "running_stats_rel": stats})


def phase_reference(sparse_impl: str, block_impl: str, size: int = 56, patch: int = 8,
                    dims=(40, 80, 160, 320), depths=(2, 2, 6, 2), **options) -> None:
    """A small f32 step on the GPU (kernels) against the CPU (plain
    versions), with the FCMAE ``options`` (``sparse``, ``use_orig_stem``,
    ``gelu_approx``, ``stem_gathered``)."""
    import numpy as np
    import torch

    from mmearth_tpu_torch.configs import modalities as M
    from mmearth_tpu_torch.data.synthetic import synthetic_batch
    from mmearth_tpu_torch.models.fcmae import FCMAE, gen_random_mask, zero_nan_inputs

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(img_size=size, patch_size=patch, depths=depths, dims=dims,
              grn_group=8, block_impl=block_impl, sparse_impl=sparse_impl,
              inp_modalities=M.INP_MODALITIES, out_modalities=M.OUT_MODALITIES, **options)
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
        raise AssertionError(f"{sparse_impl} {block_impl} {options} GPU vs CPU step: loss rel "
                             f"{rel:.2e}, worst grad {worst:.2e}")
    emit({"phase": "reference", "sparse_impl": sparse_impl, "block_impl": block_impl,
          "options": options, "input_size": size, "patch_size": patch, "dims": list(dims),
          "loss_cpu": l_cpu,
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


# the forward's launches a pretraining step makes (the rest run in the
# backward): the final scatter and, where the stem is composed, its gather
# (their transposes run in the backward), every forward launch
FORWARD_KERNELS = ("dwconv7_gathered_fwd", "spillg_fwd_a", "spillg_fwd_b", "masked_rows",
                   "masked_fwd_stat", "masked_fwd_apply", "stem_rows_fwd")
TOOLS_FT_STEPS = 4


def forward_launches(block_impl: str) -> dict:
    """The forward share of ``expected_launches``: the launches of one
    forward pass of the gathered atto56 FCMAE."""
    per_step, _ = expected_launches("gathered", block_impl, ATTO56)
    patches = {"gather_patches": per_step["gather_patches"] - 1, "scatter_patches": 1}
    return {key: patches.get(key, n if key in FORWARD_KERNELS else 0)
            for key, n in per_step.items()}


def tools_hub(checkpoint: Path) -> dict:
    """``hub.MPMAE`` from the pretraining ``checkpoint``: logits on the card
    in f32 (TF32 off) against the CPU port on the same file and input;
    then ``TOOLS_FT_STEPS`` finetune steps of the hub model (row 11 12 times
    a step, nothing else) and one probe step (no launch)."""
    import math

    import torch

    from mmearth_tpu_torch import hub
    from mmearth_tpu_torch.configs.config import FinetuneConfig, ModelConfig, RunConfig
    from mmearth_tpu_torch.losses.finetune import criterion_fn
    from mmearth_tpu_torch.train.finetune import finetune_step, make_optimizer
    from mmearth_tpu_torch.train.step import fold_in

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(FT_BATCH, 56, 56, 12, generator=gen)
    y = torch.randint(0, 10, (FT_BATCH,), generator=gen)
    logits = {}
    for dev in ("cpu", "cuda"):
        model, _ = hub.MPMAE(ckpt_path=checkpoint, num_classes=10, device=dev)
        with torch.no_grad():
            logits[dev] = model(x.to(dev)).cpu()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    if not err <= 1e-4 * scale:  # f32 on both sides: summation order only
        raise AssertionError(f"hub logits, card against CPU: {err:.3e} of scale {scale:.3e}")
    cfg = FinetuneConfig(model=ModelConfig(img_size=56, patch_size=8), batch_size=FT_BATCH,
                         run=RunConfig(epochs=100, seed=0, loss_aggr="unweighted"))
    criterion = criterion_fn("m-eurosat", 0.2)
    batch = {"input": x.cuda(), "label": y.cuda()}
    steps = {}
    for probe, n_steps in ((False, TOOLS_FT_STEPS), (True, 1)):
        model, trainable = hub.MPMAE(ckpt_path=checkpoint, num_classes=10, linear_probe=probe,
                                     drop_path_rate=0.1)
        opt = make_optimizer(cfg, model, trainable, 100 * FT_BATCH)
        dgen = torch.Generator(device="cuda").manual_seed(0)
        reset_launches()
        losses = [float(finetune_step(model, opt, batch, criterion, fold_in(dgen, i)))
                  for i in range(n_steps)]
        torch.cuda.synchronize()
        launches = read_launches()
        for name, n in launches.items():
            want = 12 * n_steps if (name == "dw_weight_grad" and not probe) else 0
            if n != want:
                raise AssertionError(f"hub {'probe' if probe else 'finetune'}, {name}: {n} "
                                     f"launches in {n_steps} steps, expected {want}")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"hub finetune losses {losses}")
        steps["probe" if probe else "finetune"] = {
            "steps": n_steps, "losses": losses,
            "dw_weight_grad_launches": launches["dw_weight_grad"]}
    return {"logits_max_abs_err": err, "logits_scale": scale, **steps}


def tools_panels(data: Path, checkpoint: Path) -> dict:
    """``run_one_batch`` on the card on 4 samples of the smoke's packed data
    with a CPU run's mask, ``auto`` and ``wholeblock``: the maps in f32
    against the CPU port's and the forward's launches against
    ``forward_launches``; then ``render_panels``: one PNG a pixel modality
    where matplotlib is installed, else the refusal naming it."""
    import numpy as np
    import torch

    from mmearth_tpu_torch.configs import modalities as M
    from mmearth_tpu_torch.eval import visualize
    from mmearth_tpu_torch.models.fcmae import FCMAE

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = visualize.load_batch(str(data / "train"), 56)
    out = {}
    for block_impl in ("auto", "wholeblock"):
        maps, mask = {}, None
        for dev in ("cpu", "cuda"):
            model = FCMAE(img_size=56, patch_size=8, depths=(2, 2, 6, 2),
                          dims=(40, 80, 160, 320), loss_aggr="unweighted", block_impl=block_impl,
                          inp_modalities=M.INP_MODALITIES, out_modalities=M.OUT_MODALITIES)
            visualize.load_fcmae(model, checkpoint)
            model.to(dev).eval()
            reset_launches()
            maps[dev], mask = visualize.run_one_batch(model, batch, mask=mask)
            launches = read_launches()
        want = forward_launches(block_impl)
        check_launches(f"panels forward ({block_impl})", launches, want, 1)
        errs = {}
        for k, ref in maps["cpu"].items():
            err, scale = float(np.abs(maps["cuda"][k] - ref).max()), float(np.abs(ref).max())
            if not err <= 1e-4 * scale:  # f32 on both sides: summation order only
                raise AssertionError(f"panels ({block_impl}) {k}: {err:.3e} of scale {scale:.3e}")
            errs[k] = err / scale
        out[block_impl] = {"forward_launches": {k: n for k, n in launches.items() if n},
                           "max_rel_err": errs}
    panels = ROOT / "build" / "smoke_panels"
    shutil.rmtree(panels, ignore_errors=True)
    try:
        visualize.render_panels(model, batch, maps["cuda"], mask, panels)
    except ImportError as e:
        if "matplotlib" not in str(e) or panels.exists():
            raise
        out["render"] = f"refused: {e}"
    else:
        pngs = sorted(p.stem for p in panels.glob("*.png"))
        if pngs != sorted(maps["cuda"]):
            raise AssertionError(f"panels written {pngs}, expected {sorted(maps['cuda'])}")
        out["render"] = f"wrote {len(pngs)} PNGs to {panels}"
    print(f"render_panels: {out['render']}", flush=True)
    return out


def tools_time_steps() -> dict:
    """``utils/profiling.py::time_steps`` on the atto56 ``wholeblock``
    ``ChainedStep`` (2 rounds of one 10-step replay after a warm-up)."""
    import torch

    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_bench

    from mmearth_tpu_torch.train.step import ChainedStep
    from mmearth_tpu_torch.utils.profiling import time_steps

    dev = torch.device("cuda")
    model, opt = torch_bench.pretrain_setup(*ATTO56[:3], ATTO56[3], "wholeblock", dev)
    data = torch_bench.device_batch(ATTO56[3], 64, dev)
    ch = ChainedStep(model, opt, {k: v.expand(10, *v.shape) for k, v in data.items()})
    gen = torch.Generator(device=dev).manual_seed(0)
    best, rounds = time_steps(lambda i: ch(i, gen), dev, k=10, rounds=2, per_call=10)
    print(f"time_steps rounds (ms/step): {rounds}", flush=True)
    return {"ms_per_step": best, "round_ms_per_step": rounds, "steps": ch.report()["steps"]}


def tools_wandb_distributed(data: Path) -> dict:
    """A one-epoch atto pretraining run through ``main_pretrain.main`` with
    ``--wandb True --distributed True``, with wandb hidden: it runs to its
    end on the card and says that wandb is missing; where wandb is
    installed, the same run with it, disabled (``WANDB_MODE``: no
    network)."""
    import contextlib
    import importlib.util
    import io
    import math

    from mmearth_tpu_torch import main_pretrain

    args = slice_args("gathered", "wholeblock", data, ATTO56, "--epochs", "1", "--wandb", "True",
                      "--distributed", "True")
    present = importlib.util.find_spec("wandb") is not None
    out = {"wandb_present": present}
    for hidden in (True, False) if present else (True,):
        buf = io.StringIO()
        saved = sys.modules.get("wandb")
        if hidden:
            sys.modules["wandb"] = None  # import wandb raises ImportError
        else:
            os.environ["WANDB_MODE"] = "disabled"
        try:
            with contextlib.redirect_stdout(buf):
                _, history, _ = main_pretrain.main(args)
        finally:
            if not hidden:
                del os.environ["WANDB_MODE"]
            elif saved is None:
                del sys.modules["wandb"]
            else:
                sys.modules["wandb"] = saved
        said = "wandb not installed; continuing without it" in buf.getvalue()
        losses = history[0]["step_losses"]
        if len(history) != 1 or not losses or not all(map(math.isfinite, losses)) \
                or said != hidden:
            raise AssertionError(f"--wandb True --distributed True (wandb hidden {hidden}): "
                                 f"{history}, said missing {said}")
        out["hidden" if hidden else "disabled"] = {"said_missing": said, "steps": len(losses),
                                                   "losses": losses}
    return out


def phase_tools(card: str, data: Path, checkpoint: Path, bench_line: dict) -> dict:
    """The tools on the card: the diagnostics' report, the hub
    (:func:`tools_hub`), the reconstruction panels (:func:`tools_panels`),
    the model FLOPs of an atto56 step (on the CPU, at batch 2, scaled) and
    the MFU of the bench phase's replayed ms/step, the step
    timer (:func:`tools_time_steps`), and ``--wandb True --distributed
    True`` (:func:`tools_wandb_distributed`)."""
    from mmearth_tpu_torch.utils import flops
    from mmearth_tpu_torch.utils.diagnostics import print_diagnostics

    t0 = time.time()
    print_diagnostics()
    out = {"phase": "tools", "card": card, "hub": tools_hub(checkpoint),
           "panels": tools_panels(data, checkpoint)}
    t1 = time.time()
    per_sample = flops.pretrain_step_flops(*ATTO56[:3], 2) / 2
    mfu = flops.mfu(per_sample * ATTO56[3], bench_line["ms_per_step"])
    if not 0.0 < mfu < 1.0:
        raise AssertionError(f"MFU {mfu} of {per_sample / 1e9} GFLOP/sample at "
                             f"{bench_line['ms_per_step']} ms/step")
    out["flops"] = {"step_gflops_per_sample": per_sample / 1e9, "count_seconds": time.time() - t1,
                    "bench_ms_per_step": bench_line["ms_per_step"], "mfu": mfu,
                    "bench_mfu": bench_line["mfu"]}
    out["time_steps"] = tools_time_steps()
    out["wandb_distributed"] = tools_wandb_distributed(data)
    out["seconds"] = round(time.time() - t0, 2)
    emit(out)
    return out


DIST_CHILD = "--dist-child"  # argv[1] of the processes phase_distributed starts
DIST_STEPS_PER_DISPATCH = 4  # atto56 at batch 256: 4 steps an epoch, one dispatch
DIST_REF_DIMS = (40, 80, 160, 320)  # (c): atto widths, one block a stage
DIST_REF_N = 8  # (c): the global batch, 4 a rank


def dist_child(kind: str, out_path: str, flags: list[str]) -> int:
    """A process of :func:`phase_distributed`: ``main_pretrain.main`` or
    ``main_finetune.main`` (``kind``) on the CLI ``flags``, as ``python -m``
    runs it, under torchrun's variables or without them.  It makes the
    process group first (so that it outlives the run), counts the
    ``all_reduce`` calls and those issued while a CUDA graph was being
    captured, times the gradient all-reduce of the trained model's params,
    and writes the history and these to ``out_path`` as JSON."""
    import torch
    import torch.distributed as dist

    from mmearth_tpu_torch import main_finetune, main_pretrain
    from mmearth_tpu_torch.parallel import mesh

    cli = main_pretrain if kind == "pretrain" else main_finetune
    args = cli.get_args_parser().parse_args(flags)
    d = mesh.init_distributed(args.device)
    calls = {"all_reduce": 0, "captured": 0}
    real = dist.all_reduce

    def counted(tensor, *a, **kw):
        calls["all_reduce"] += 1
        calls["captured"] += int(torch.cuda.is_current_stream_capturing())
        return real(tensor, *a, **kw)

    dist.all_reduce = counted
    out = cli.main(args)
    dist.all_reduce = real
    model, history = (out[0], out[1]) if kind == "pretrain" else (out["model"], out["history"])
    res = {"world": mesh.world_size(d.group), "device": str(d.device),
           "backend": dist.get_backend(d.group) if d.group is not None else None,
           "calls": calls, "history": [{k: e[k] for k in ("epoch", "loss", "steps", "seconds",
                                                           "step_losses")} for e in history]}
    if kind == "finetune":
        res["test"] = out["test_Accuracy"]
    if d.group is not None:
        grads = [torch.zeros_like(p) for p in model.parameters() if p.requires_grad]
        res["grad_allreduce"] = {"params": sum(g.numel() for g in grads),
                                 "ms": time_ms(lambda: mesh.all_reduce_grads(grads, d.group))}
    mesh.close(d)
    Path(out_path).write_text(json.dumps(res))
    return 0


def run_child(kind: str, flags: list[str], torchrun: bool, tag: str) -> dict:
    """:func:`dist_child` in a process of its own (under ``torchrun
    --standalone --nproc_per_node 1`` where ``torchrun``); its JSON."""
    out = ROOT / "build" / f"smoke_dist_{tag}.json"
    out.unlink(missing_ok=True)
    import torch

    launcher = ([sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node", "1"] if torchrun else [sys.executable])
    # torchrun sets OMP_NUM_THREADS=1 where it is unset, which slows the
    # host's tensor work (the chained batches' stack): both runs get this
    # process's thread count, so that they differ by the group alone
    env = {**os.environ, "OMP_NUM_THREADS": str(torch.get_num_threads())}
    t0 = time.time()
    r = subprocess.run([*launcher, str(ROOT / "chip_smoke.py"), DIST_CHILD, kind, str(out),
                        *flags], cwd=ROOT, capture_output=True, text=True, timeout=600,
                       env=env)
    if r.returncode != 0:
        raise AssertionError(f"{tag}: exit {r.returncode}\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-6000:]}")
    res = json.loads(out.read_text())
    res["process_seconds"] = round(time.time() - t0, 2)
    return res


def steady_ms(history: list[dict]) -> float:
    """ms/step over the epochs after the first (which captures)."""
    steady = history[1:]
    return 1e3 * sum(e["seconds"] for e in steady) / sum(e["steps"] for e in steady)


def dist_rank(rank: int, world: int, port: int, work: str) -> None:
    """Rank ``rank`` of (c): gloo on ``cuda:0``, each FCMAE of
    ``work/inputs.pt`` under the global GRN scope on the rank's rows of the
    global batch and mask, one forward and backward, the gradients
    averaged over the ranks; writes the loss, the gradients and the
    launches of each to ``work/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from mmearth_tpu_torch.models.fcmae import FCMAE
    from mmearth_tpu_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    d = mesh.init_distributed("cuda:0")
    inp = torch.load(Path(work) / "inputs.pt", weights_only=False)
    n = DIST_REF_N // world
    rows = slice(rank * n, (rank + 1) * n)
    out = {}
    for sparse_impl, block_impl in (("gathered", "wholeblock"), ("masked_dense", "fused")):
        model = FCMAE(**inp["kw"], sparse_impl=sparse_impl, block_impl=block_impl).cuda()
        model.load_state_dict(inp["sd"])
        mesh.set_process_group(model, d.group)
        batch = {k: v[rows].cuda() for k, v in inp["batch"].items()}
        reset_launches()
        loss = model(batch, mask=inp["mask"][rows].cuda())[0]
        loss.backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        mesh.all_reduce_grads(grads, d.group)
        torch.cuda.synchronize()
        out[block_impl] = {"loss": float(loss.detach()), "launches": read_launches(),
                           "grads": {k: p.grad.detach().cpu() for k, p in
                                     model.named_parameters() if p.grad is not None}}
    torch.save(out, Path(work) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def dist_two_ranks() -> dict:
    """(c): two gloo ranks on ``cuda:0`` (:func:`dist_rank`) against one
    process on the concatenated batch, f32, TF32 off: each rank's loss
    within 1e-4 of the one process's and its averaged gradients within
    1e-3 of each tensor's largest magnitude, as the reference phases hold
    the GPU against the CPU; the spill-g launches under ``wholeblock`` and
    the masked-dense ones under ``fused`` counted in each rank."""
    import socket

    import torch
    import torch.multiprocessing as mp

    from mmearth_tpu_torch.configs import modalities as M
    from mmearth_tpu_torch.data.synthetic import synthetic_batch
    from mmearth_tpu_torch.models.fcmae import FCMAE, gen_random_mask, zero_nan_inputs
    from mmearth_tpu_torch.ops import fused_block as fb

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = ROOT / "build" / "smoke_dist_ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    kw = dict(img_size=56, patch_size=8, depths=(1, 1, 1, 1), dims=DIST_REF_DIMS, grn_group=0,
              inp_modalities=M.INP_MODALITIES, out_modalities=M.OUT_MODALITIES)
    ref = FCMAE(**kw).init_weights(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if ".grn." in name:
                p.normal_(0.0, 0.5, generator=gen)
    batch = zero_nan_inputs({k: torch.from_numpy(v) for k, v in
                             synthetic_batch(DIST_REF_N, 56, seed=1).items()})
    mask = gen_random_mask(DIST_REF_N, 49, 0.6, torch.Generator().manual_seed(2))
    torch.save({"kw": kw, "sd": ref.state_dict(), "batch": batch, "mask": mask},
               work / "inputs.pt")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.time()
    mp.spawn(dist_rank, args=(2, port, str(work)), nprocs=2, join=True)
    seconds = time.time() - t0
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    out = {"spawn_and_run_seconds": round(seconds, 2)}
    for sparse_impl, block_impl in (("gathered", "wholeblock"), ("masked_dense", "fused")):
        model = FCMAE(**kw, sparse_impl=sparse_impl, block_impl=block_impl).cuda()
        model.load_state_dict(ref.state_dict())
        loss = model({k: v.cuda() for k, v in batch.items()}, mask=mask.cuda())[0]
        loss.backward()
        want = {k: p.grad.detach().cpu() for k, p in model.named_parameters()
                if p.grad is not None}
        own = ([k for k in fb.SPILLG_LAUNCHES if k != "spillg_bwd_c_dw2"]  # folds at atto
               if block_impl == "wholeblock" else fb.MASKED_LAUNCHES)
        res = {"loss_one_process": float(loss.detach()), "ranks": []}
        for r, got in enumerate(ranks):
            g = got[block_impl]
            rel = abs(g["loss"] - res["loss_one_process"]) / abs(res["loss_one_process"])
            worst = max(float((g["grads"][k] - want[k]).abs().max()
                              / (want[k].abs().max() + 1e-12)) for k in want)
            launched = {k: g["launches"][k] for k in own}
            if not (rel < 1e-4 and worst < 1e-3) or not all(launched.values()):
                raise AssertionError(f"two ranks, {block_impl}, rank {r}: loss rel {rel:.2e}, "
                                     f"worst grad {worst:.2e}, launches {launched}")
            res["ranks"].append({"loss": g["loss"], "loss_rel": rel, "worst_grad_rel": worst,
                                 "launches": launched})
        out[block_impl] = res
    return out


def dist_replay_ab(k: int = 8, replays: int = 5) -> dict:
    """The group's cost in a replayed step, host input excluded: atto56
    ``wholeblock`` at batch 256 on a resident batch, a ``ChainedStep`` of k
    steps without a group and one under a one-rank NCCL group made here
    (its loss sums and gradient average captured), replayed in turns
    alone, group, group, alone, ``replays`` replays a turn, CUDA-event
    ms/step; and the gradient average alone (``all_reduce_grads``: host
    included, and its all-reduce of the flat buffer alone)."""
    import socket

    import torch
    import torch.distributed as dist

    from mmearth_tpu_torch.configs import modalities as M
    from mmearth_tpu_torch.data.synthetic import bench_batch
    from mmearth_tpu_torch.models.fcmae import FCMAE
    from mmearth_tpu_torch.parallel import mesh
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.step import ChainedStep, to_device

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    model_name, size, patch, batch_size = ATTO56
    batch = to_device(bench_batch(batch_size, 64, seed=1), "cuda")
    chains = {}
    try:
        for name, group in (("alone", None), ("group", dist.group.WORLD)):
            model = FCMAE(img_size=size, patch_size=patch, depths=(2, 2, 6, 2),
                          dims=(40, 80, 160, 320), grn_group=batch_size,
                          block_impl="wholeblock", dtype=torch.bfloat16,
                          inp_modalities=M.INP_MODALITIES, out_modalities=M.OUT_MODALITIES)
            model = mesh.set_process_group(
                model.init_weights(torch.Generator().manual_seed(0)).cuda(), group)
            opt = AdamW(model.named_parameters(), lambda n: 1e-4, process_group=group)
            gen = torch.Generator(device="cuda").manual_seed(0)
            ch = ChainedStep(model, opt, {key: v.expand(k, *v.shape) for key, v in batch.items()})
            ch(0, gen)  # warm-up and capture
            chains[name] = ch, gen, model
        ms = {"alone": [], "group": []}
        for name in ("alone", "group", "group", "alone"):
            ch, gen, _ = chains[name]
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(replays):
                ch(k * (i + 1), gen)
            end.record()
            torch.cuda.synchronize()
            ms[name].append(start.elapsed_time(end) / (replays * k))
        grads = [torch.zeros_like(p) for p in chains["group"][2].parameters()]
        flat = torch.zeros(sum(g.numel() for g in grads), device="cuda")
        out = {"k": k, "replays_a_turn": replays, "replay_ms_per_step": ms,
               "group_minus_alone_ms": statistics.mean(ms["group"]) - statistics.mean(ms["alone"]),
               "grad_params": flat.numel(),
               "all_reduce_grads_ms": time_ms(lambda: mesh.all_reduce_grads(
                   grads, dist.group.WORLD)),
               "flat_all_reduce_ms": time_ms(lambda: dist.all_reduce(flat))}
    finally:
        dist.destroy_process_group()
    return out


def phase_distributed(card: str, data: Path, geobench: Path, checkpoint: Path,
                      foreign: Path) -> dict:
    """Data parallelism on the card: (a) atto56 ``wholeblock`` pretraining
    under torchrun (NCCL, world size 1) with the all-reduces captured into
    the chained graph, against the same run without a group, and the
    group's cost in a replay (:func:`dist_replay_ab`); (b) the finetune
    driver under torchrun for the classifier and ``resnet18``; (c) two gloo
    ranks on the one card (:func:`dist_two_ranks`)."""
    import math

    t0 = time.time()
    model_name, size, patch, batch = ATTO56
    flags = ["--model", model_name, "--input_size", str(size), "--patch_size", str(patch),
             "--batch_size", str(batch), "--use_bf16", "True", "--device", "cuda",
             "--processed_dir", str(data), "--epochs", "3", "--warmup_epochs", "1", "--seed",
             "0", "--block_impl", "wholeblock", "--steps_per_dispatch",
             str(DIST_STEPS_PER_DISPATCH), "--distributed", "True"]
    group = run_child("pretrain", flags, True, "pretrain_nccl")
    alone = run_child("pretrain", flags, False, "pretrain_alone")
    mine = [x for e in group["history"] for x in e["step_losses"]]
    theirs = [x for e in alone["history"] for x in e["step_losses"]]
    worst = max(abs(a - b) / abs(b) for a, b in zip(mine, theirs))
    if (group["world"], group["backend"]) != (1, "nccl") or alone["backend"] is not None \
            or len(mine) != len(theirs) or len(mine) < 12 or worst > 1e-3 \
            or not group["calls"]["captured"] or alone["calls"]["all_reduce"]:
        raise AssertionError(f"pretraining under torchrun: {group['world']} {group['backend']} "
                             f"{group['calls']}, losses {mine} against {theirs} "
                             f"(alone {alone['calls']})")
    out = {"phase": "distributed", "card": card,
           "pretrain": {"losses_group": mine, "losses_alone": theirs, "worst_loss_rel": worst,
                        "ms_per_step_group": steady_ms(group["history"]),
                        "ms_per_step_alone": steady_ms(alone["history"]),
                        "all_reduce_calls": group["calls"],
                        "grad_allreduce": group["grad_allreduce"],
                        "process_seconds": [group["process_seconds"],
                                            alone["process_seconds"]]}}
    ft = {}
    for name, data_set, path in (("convnextv2_atto", "m-eurosat", checkpoint),
                                 ("resnet18", "m-eurosat", foreign / "seco_resnet18.pth")):
        ft_flags = ["--model", name, "--input_size", str(size), "--patch_size", str(patch),
                    "--data_set", data_set, "--finetune", str(path), "--processed_dir",
                    str(geobench), "--batch_size", str(FT_BATCH), "--epochs", "1",
                    "--use_bf16", "True", "--seed", "0", "--device", "cuda",
                    "--distributed", "True"]
        res = run_child("finetune", ft_flags, True, f"finetune_{name}")
        losses = [x for e in res["history"] for x in e["step_losses"]]
        if (res["world"], res["backend"]) != (1, "nccl") or not losses \
                or not all(map(math.isfinite, losses)) or not 0.0 <= res["test"] <= 1.0 \
                or not res["calls"]["all_reduce"]:
            raise AssertionError(f"{name} finetune under torchrun: {res}")
        ft[name] = {"steps": len(losses), "epoch_loss": [e["loss"] for e in res["history"]],
                    "test_accuracy": res["test"], "all_reduce_calls": res["calls"],
                    "grad_allreduce": res["grad_allreduce"],
                    "process_seconds": res["process_seconds"]}
    out["finetune"] = ft
    out["replay"] = dist_replay_ab()
    out["two_ranks"] = dist_two_ranks()
    out["seconds"] = round(time.time() - t0, 2)
    emit(out)
    return out



MA_PATHS = (("gathered", "wholeblock"), ("masked_dense", "fused"))
MA_STEPS, MA_TIMED = 2, 3  # AdamW steps held against one process, then eager steps timed
MA_LR = 1e-3
# atto56 at full width (dims 40-320, decoder 512, all 12 output modalities)
MA_CONFIG = dict(img_size=56, patch_size=8, depths=(2, 2, 6, 2), dims=(40, 80, 160, 320),
                 decoder_embed_dim=512, batch=256)


MA_FT_STEPS, MA_FT_LR = 3, 1e-3  # Adafactor classifier steps held against one process
# the finetune recipe's classifier: dense atto at 112/16, 12 bands, 10 classes
MA_FT_KW = dict(img_size=112, patch_size=16, in_chans=12, num_classes=10, depths=(2, 2, 6, 2),
                dims=(40, 80, 160, 320))


def ma_rows(block_impl: str) -> tuple:
    """The launch keys of the kernel rows a path runs: 1-4 and 7-10 under
    ``wholeblock`` (C's separate dW2 pass folds at atto widths), 5-6 and 11
    under ``fused``."""
    from mmearth_tpu_torch.ops import fused_block as fb

    if block_impl == "wholeblock":
        return GATHERED_KERNELS + STEM_KERNELS + tuple(k for k in fb.SPILLG_LAUNCHES
                                                       if k != SPILLG_WIDE_DW2)
    return fb.MASKED_LAUNCHES + ("dw_weight_grad",)


def adam_moves(grads, lr: float, betas=(0.9, 0.95), eps: float = 1e-8):
    """Each element's total Adam displacement over the steps of ``grads``
    (numpy arrays), in f64, before weight decay."""
    import numpy as np

    b1, b2 = betas
    mu = nu = move = 0.0
    for t, g in enumerate(grads, 1):
        g = np.asarray(g, np.float64)
        mu, nu = b1 * mu + (1 - b1) * g, b2 * nu + (1 - b2) * g * g
        move = move + lr * (mu / (1 - b1 ** t)) / (np.sqrt(nu / (1 - b2 ** t)) + eps)
    return move


def ma_whole_grads(model, grid) -> dict:
    """Each param's gradient after a step, a split leaf's gathered over the
    model group, on the CPU."""
    import torch
    import torch.distributed as dist

    from mmearth_tpu_torch.parallel import mesh

    split, out = mesh.shard_keys(model), {}
    for k, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad.detach().contiguous()
        if k in split:
            parts = [torch.empty_like(g) for _ in range(grid.model)]
            dist.all_gather(parts, g, group=grid.model_group)
            g = torch.cat(parts)
        out[k] = g.cpu().clone()
    return out


def adafactor_moves(grads, lr: float, dims, decay_rate: float = 0.8, eps: float = 1e-30):
    """Each element's total Adafactor displacement over the steps of
    ``grads`` (whole leaves, numpy arrays), in f64: the factored statistics
    over ``dims`` (d1, d0), or the per-element ones where None, whose step
    is ~ sign(g) * lr as Adam's first is."""
    import numpy as np

    v_row = v_col = v = move = 0.0
    for t, g in enumerate(grads, 1):
        g = np.asarray(g, np.float64)
        decay = 1.0 - t ** -decay_rate
        sq = g * g + eps
        if dims is None:
            v = decay * v + (1 - decay) * sq
            move = move + lr * g / np.sqrt(v)
            continue
        d1, d0 = dims
        v_row = decay * v_row + (1 - decay) * sq.mean(axis=d0)
        v_col = decay * v_col + (1 - decay) * sq.mean(axis=d1)
        row = v_row / v_row.mean(axis=d1 - 1 if d1 > d0 else d1, keepdims=True)
        move = move + lr * g / np.sqrt(np.expand_dims(row, d0) * np.expand_dims(v_col, d1))
    return move


def ma_adafactor(inp, grid, dev) -> dict:
    """MA_FT_STEPS Adafactor steps of the recipe's classifier (layer decay
    0.9, weight decay 0.3, clip 1.0, drop path 0) on ``grid`` (a (1, W)
    grid: every rank the whole batch; None: one process), then MA_TIMED
    more timed: each held step's loss and whole gradients, row 11's
    launches in them, the whole params and v_row/v_col/v after them
    (``gather_state``), the rank's own params, the split and the factored
    leaves, eager ms/step."""
    import torch

    from mmearth_tpu_torch.losses.finetune import criterion_fn
    from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
    from mmearth_tpu_torch.parallel import mesh
    from mmearth_tpu_torch.train.finetune import finetune_step
    from mmearth_tpu_torch.train.optim import Optimizer, finetune_wd_mask, layer_lr_scales

    model = ConvNeXtV2(**inp["ft_kw"], sparse=False)
    model.load_state_dict(inp["ft_sd"])
    model = mesh.shard_params(model.to(dev), grid)
    named = list(model.named_parameters())
    opt = Optimizer(named, lambda count: MA_FT_LR, 0.3, (0.9, 0.999), clip_grad=1.0,
                    wd_mask=finetune_wd_mask(named),
                    lr_scales=layer_lr_scales(named, 0.9, inp["ft_kw"]["depths"]),
                    opt="adafactor", process_group=grid, shards=mesh.shard_keys(model))
    batch = {"input": inp["ft_x"].to(dev), "label": inp["ft_y"].to(dev)}
    criterion = criterion_fn("m-eurosat", 0.2)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    reset_launches()
    losses, grads = [], []
    for _ in range(MA_FT_STEPS):
        losses.append(float(finetune_step(model, opt, batch, criterion, None)))
        grads.append(ma_whole_grads(model, grid))
    launches = read_launches()["dw_weight_grad"]
    sd, opt_sd = mesh.gather_state(model, opt, grid)
    cpu = lambda t: t.detach().cpu().clone()  # noqa: E731
    out = {"losses": losses, "grads": grads, "launches": launches,
           "whole": {k: cpu(v) for k, v in sd.items()},
           "slots": {k: {n: cpu(t) for n, t in opt_sd[k].items()} for k in ("v_row", "v_col", "v")},
           "own": {k: cpu(p) for k, p in model.named_parameters()},
           "split": mesh.shard_keys(model),
           "factored": {n for n, f in zip(opt.names, opt.factored) if f is not None}}
    sync()
    t0 = time.perf_counter()
    for _ in range(MA_TIMED):
        finetune_step(model, opt, batch, criterion, None)
    sync()
    out["ms_per_step"] = 1e3 * (time.perf_counter() - t0) / MA_TIMED
    return out


def ma_adafactor_check(card: str, inp, one: dict, got: list) -> dict:
    """The ranks' Adafactor run (:func:`ma_adafactor`) against one
    process's: every stage-2 and stage-3 ``pwconv1`` split and factored;
    each step's loss within 1e-4 relative; the gradients within 1e-3 of
    each tensor's scale; the gathered slots within 1e-4 of each tensor's
    scale; the params within 1e-4 of scale plus the gap that Adafactor's
    steps on the two sides' own gradients put between them (an unfactored
    leaf's step is ~ sign(g) * lr); replicated leaves bit-identical on the
    ranks; row 11 launched 12 times a step on each rank."""
    import numpy as np
    import torch

    from mmearth_tpu_torch.train.optim import factored_dims, finetune_wd_mask

    split = got[0]["split"]
    pw = [k for k in one["whole"] if k.endswith("pwconv1.weight")
          and k.startswith(("stages.2.", "stages.3."))]
    unfit = [k for k in pw for g in got if k not in g["split"] or k not in g["factored"]]
    loss_rel = max(abs(a - b) / abs(b) for g in got for a, b in zip(g["losses"], one["losses"]))
    rel = lambda a, b: float((a - b).abs().max() / (b.abs().max() + 1e-12))  # noqa: E731
    grad_rel = max(rel(g["grads"][s][k], one["grads"][s][k])
                   for g in got for s in range(MA_FT_STEPS) for k in one["grads"][s])
    slot_rel = max(rel(g["slots"][slot][k], w) for g in got
                   for slot, per in one["slots"].items() for k, w in per.items())
    decayed = finetune_wd_mask(one["whole"].items())
    param_rel, param_excess, worst_key = 0.0, -float("inf"), None
    for k, want in one["whole"].items():
        start = inp["ft_sd"][k].double().numpy()

        def moves(grads):
            steps = [gr[k].double().numpy() + (0.3 * start if decayed[k] else 0.0)
                     for gr in grads]
            return adafactor_moves(steps, MA_FT_LR, factored_dims(want.shape))

        diff = (got[0]["whole"][k] - want).abs().double().numpy()
        scale = float(want.abs().max()) or 1.0
        spread = np.abs(moves(got[0]["grads"]) - moves(one["grads"]))
        excess = float((diff - 1e-4 * scale - spread).max())
        param_rel = max(param_rel, float(diff.max()) / scale)
        if excess > param_excess:
            param_excess, worst_key = excess, k
        if k not in split and not all(torch.equal(g["own"][k], got[0]["own"][k]) for g in got):
            raise AssertionError(f"model axis, adafactor: replicated {k} differs on the ranks")
    launched = [g["launches"] / MA_FT_STEPS for g in got]
    row = {"phase": "model_axis_adafactor", "card": card, "grid": [1, len(got)],
           "batch": FT_BATCH, "steps": MA_FT_STEPS, "losses_one_process": one["losses"],
           "losses_ranks": [g["losses"] for g in got], "loss_rel": loss_rel,
           "worst_grad_rel": grad_rel, "worst_slot_rel": slot_rel, "worst_param_rel": param_rel,
           "param_excess": param_excess, "worst_param_key": worst_key,
           "split_leaves": len(split), "factored_split_leaves": len(split & got[0]["factored"]),
           "pwconv1_split_and_factored": len(pw) - len(set(unfit)),
           "dw_weight_grad_per_step_ranks": launched,
           "dw_weight_grad_per_step_one_process": one["launches"] / MA_FT_STEPS,
           "ms_per_step_one_process": one["ms_per_step"],
           "ms_per_step_ranks": [g["ms_per_step"] for g in got]}
    emit(row)
    if not (len(pw) == 8 and not unfit and loss_rel < 1e-4 and grad_rel < 1e-3
            and slot_rel < 1e-4 and param_excess <= 0.0 and all(n == 12 for n in launched)
            and all(np.isfinite(g["losses"]).all() for g in got)):
        raise AssertionError(f"model axis, adafactor: {row}, not split and factored: {unfit}")
    return row


def ma_steps(model, opt, batch, gen, grads_of=None) -> tuple[list, list]:
    """MA_STEPS AdamW steps with drawn masks: their losses and gradients."""
    from mmearth_tpu_torch.train.step import pretrain_step

    losses, grads = [], []
    for i in range(MA_STEPS):
        losses.append(float(pretrain_step(model, opt, batch, i, gen, random_crop=False)["loss"]))
        grads.append(grads_of(model))
    return losses, grads


def ma_timed_ms(model, opt, batch, gen) -> float:
    """Eager ms/step of MA_TIMED more steps, host clock, synchronised."""
    import torch

    from mmearth_tpu_torch.train.step import pretrain_step

    dev = next(model.parameters()).device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(MA_TIMED):
        pretrain_step(model, opt, batch, MA_STEPS + i, gen, random_crop=False)
    sync()
    return 1e3 * (time.perf_counter() - t0) / MA_TIMED


def ma_collective_ms(model, opt, batch, gen) -> dict:
    """One more step with every ``all_gather`` and ``all_reduce`` timed on
    the host, the device synchronised around each: the step's ms and the
    collectives' ms (synchronising costs the step its overlap, so the share
    is an upper bound)."""
    import torch
    import torch.distributed as dist

    from mmearth_tpu_torch.train.step import pretrain_step

    dev = next(model.parameters()).device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    spent = {"all_gather": 0.0, "all_reduce": 0.0}
    calls = dict.fromkeys(spent, 0)
    real = {name: getattr(dist, name) for name in spent}

    def timed(name):
        def f(*a, **kw):
            sync()
            t = time.perf_counter()
            out = real[name](*a, **kw)
            sync()
            spent[name] += time.perf_counter() - t
            calls[name] += 1
            return out
        return f

    for name in spent:
        setattr(dist, name, timed(name))
    try:
        sync()
        t0 = time.perf_counter()
        pretrain_step(model, opt, batch, MA_STEPS + MA_TIMED, gen, random_crop=False)
        sync()
        step = time.perf_counter() - t0
    finally:
        for name in spent:
            setattr(dist, name, real[name])
    return {"step_ms": 1e3 * step, **{f"{k}_ms": 1e3 * v for k, v in spent.items()},
            "calls": calls, "share": sum(spent.values()) / step}


def ma_rank(rank: int, world: int, port: int, work: str) -> None:
    """Rank ``rank`` of :func:`phase_model_axis`: gloo, a (1, ``world``)
    grid on the inputs' device; each path's MA_STEPS AdamW steps (f32, TF32
    off) with its launches counted, its eager ms/step and the collectives'
    time a step, one bf16 step, then the classifier's Adafactor steps
    (:func:`ma_adafactor`) and ``dryrun_multichip``; writes them to
    ``work/rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from mmearth_tpu_torch.dryrun import dryrun_multichip
    from mmearth_tpu_torch.models.fcmae import FCMAE
    from mmearth_tpu_torch.parallel import mesh
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.step import to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    inp = torch.load(Path(work) / "inputs.pt", weights_only=False)
    dev = torch.device(inp["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    grid = mesh.create_mesh(1, world, dist.group.WORLD)
    batch = to_device(inp["batch"], dev)
    out = {}
    for sparse_impl, block_impl in MA_PATHS:
        res = {}
        for dtype in (torch.float32, torch.bfloat16):
            model = FCMAE(**inp["kw"], sparse_impl=sparse_impl, block_impl=block_impl,
                          dtype=dtype)
            model.load_state_dict(inp["sd"])
            model = mesh.shard_params(model.to(dev), grid)
            opt = AdamW(model.named_parameters(), lambda count: MA_LR, process_group=grid,
                        shards=mesh.shard_keys(model))
            gen = torch.Generator(device=dev).manual_seed(0)
            if dtype == torch.bfloat16:
                res["bf16_losses"] = ma_steps(model, opt, batch, gen, lambda m: None)[0][:1]
                continue
            reset_launches()
            res["losses"], res["grads"] = ma_steps(model, opt, batch, gen,
                                                   lambda m: ma_whole_grads(m, grid))
            res["launches"] = read_launches()
            res["own"] = {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
            res["split"] = mesh.shard_keys(model)
            res["ms_per_step"] = ma_timed_ms(model, opt, batch, gen)
            res["collectives"] = ma_collective_ms(model, opt, batch, gen)
            del model, opt
        out[block_impl] = res
    out["adafactor"] = ma_adafactor(inp, grid, dev)
    out["dryrun"] = dryrun_multichip(str(dev))
    torch.save(out, Path(work) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def phase_model_axis(card: str, device: str = "cuda:0", config: dict = MA_CONFIG,
                     world: int = 2) -> dict:
    """The tensor-parallel ``model`` axis (``parallel/mesh.py``): ``world``
    gloo ranks on the one card as a (1, ``world``) grid (:func:`ma_rank`),
    splitting every ``pwconv1``, ``proj`` and head, at the flagship's full
    width (atto56, batch 256), gathered ``wholeblock`` and masked-dense
    ``fused``, against this process at ``model`` 1 on the same weights,
    batch and drawn masks, f32, TF32 off: each step's loss within 1e-4
    relative; the gradients within 1e-3 of each tensor's scale; the params
    after MA_STEPS steps (each split leaf its ranks' slices concatenated)
    within 1e-4 of each tensor's scale plus how far apart Adam's steps on
    the two sides' own gradients put them (Adam divides by a gradient's own
    magnitude: near 0 a difference of ulps moves its step by up to the lr);
    every replicated leaf bit-identical on the ranks; every launch key of
    the path's kernel rows counted on each rank (the kernels fed gathered
    weights); a bf16 step a path finite; the recipe's classifier under
    Adafactor, its stage-2 and stage-3 ``pwconv1`` split and factored
    (:func:`ma_adafactor_check`); and ``dryrun_multichip`` through the same
    ranks.  Prints ms/step of each grid eagerly and the collectives' share
    of a step."""
    import socket

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from mmearth_tpu_torch.configs import modalities as M
    from mmearth_tpu_torch.data.synthetic import synthetic_batch
    from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
    from mmearth_tpu_torch.models.fcmae import FCMAE
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.step import to_device

    t0 = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = ROOT / "build" / "smoke_model_axis"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    cfg = dict(config)
    n = cfg.pop("batch")
    kw = dict(**cfg, grn_group=0, inp_modalities=M.INP_MODALITIES,
              out_modalities=M.OUT_MODALITIES)
    ref = FCMAE(**kw).init_weights(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if ".grn." in name:
                p.normal_(0.0, 0.5, generator=gen)
    sd = ref.state_dict()
    batch_np = synthetic_batch(n, cfg["img_size"], seed=1)
    ft = ConvNeXtV2(**MA_FT_KW, sparse=False)
    ft.init_weights(torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, p in ft.named_parameters():
            if ".grn." in name:
                p.normal_(0.0, 0.5, generator=gen)
    size = MA_FT_KW["img_size"]
    ft_inp = {"ft_kw": MA_FT_KW, "ft_sd": ft.state_dict(),
              "ft_x": torch.randn(FT_BATCH, size, size, MA_FT_KW["in_chans"], generator=gen),
              "ft_y": torch.randint(0, MA_FT_KW["num_classes"], (FT_BATCH,), generator=gen)}
    torch.save({"kw": kw, "sd": sd, "batch": batch_np, "device": device, **ft_inp},
               work / "inputs.pt")
    dev = torch.device(device)
    batch = to_device(batch_np, dev)
    one = {}
    for sparse_impl, block_impl in MA_PATHS:
        model = FCMAE(**kw, sparse_impl=sparse_impl, block_impl=block_impl)
        model.load_state_dict(sd)
        model = model.to(dev)
        opt = AdamW(model.named_parameters(), lambda count: MA_LR)
        g = torch.Generator(device=dev).manual_seed(0)
        losses, grads = ma_steps(model, opt, batch, g,
                                 lambda m: {k: p.grad.detach().cpu().clone() if p.grad is not None
                                            else torch.zeros_like(p).cpu()
                                            for k, p in m.named_parameters()})
        one[block_impl] = {"losses": losses, "grads": grads,
                           "params": {k: p.detach().cpu().clone()
                                      for k, p in model.named_parameters()},
                           "ms_per_step": ma_timed_ms(model, opt, batch, g)}
        del model, opt
    del batch
    one_ada = ma_adafactor(ft_inp, None, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t1 = time.time()
    mp.spawn(ma_rank, args=(world, port, str(work)), nprocs=world, join=True)
    spawn_s = time.time() - t1
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(world)]
    out = {"phase": "model_axis", "card": card, "grid": [1, world], "batch": n,
           "spawn_and_run_seconds": round(spawn_s, 2)}
    for _, block_impl in MA_PATHS:
        o = one[block_impl]
        got = [r[block_impl] for r in ranks]
        split = got[0]["split"]
        loss_rel = max(abs(a - b) / abs(b) for g in got for a, b in zip(g["losses"], o["losses"]))
        grad_rel = max(float((got[0]["grads"][s][k] - o["grads"][s][k]).abs().max()
                             / (o["grads"][s][k].abs().max() + 1e-12))
                       for s in range(MA_STEPS) for k in o["grads"][s])
        param_rel, param_excess, worst_key = 0.0, -float("inf"), None
        for k, want in o["params"].items():
            parts = [g["own"][k] for g in got]
            if k in split:
                whole = torch.cat(parts)
            else:
                whole = parts[0]
                for i, other in enumerate(parts[1:], 1):
                    if not torch.equal(other, whole):
                        raise AssertionError(f"model axis, {block_impl}: replicated {k} differs "
                                             f"on rank {i}")
            scale = float(want.abs().max()) or 1.0
            diff = (whole - want).abs().double().numpy()
            spread = np.abs(adam_moves([g[k].numpy() for g in got[0]["grads"]], MA_LR)
                            - adam_moves([g[k].numpy() for g in o["grads"]], MA_LR))
            excess = float((diff - 1e-4 * scale - spread).max())
            param_rel = max(param_rel, float(diff.max()) / scale)
            if excess > param_excess:
                param_excess, worst_key = excess, k
        launched = [{k: g["launches"][k] for k in ma_rows(block_impl)} for g in got]
        bf16 = [x for g in got for x in g["bf16_losses"]]
        if not (loss_rel < 1e-4 and grad_rel < 1e-3 and param_excess <= 0.0
                and all(all(v > 0 for v in lr.values()) for lr in launched)
                and all(np.isfinite(bf16))):
            raise AssertionError(
                f"model axis, {block_impl}: loss rel {loss_rel:.2e}, worst grad {grad_rel:.2e}, "
                f"param excess {param_excess:.2e} ({worst_key}), launches {launched}, "
                f"bf16 losses {bf16}")
        out[block_impl] = {
            "losses_one_process": o["losses"], "losses_ranks": [g["losses"] for g in got],
            "loss_rel": loss_rel, "worst_grad_rel": grad_rel, "worst_param_rel": param_rel,
            "split_leaves": len(split), "launches_ranks": launched, "bf16_losses": bf16,
            "ms_per_step_one_process": o["ms_per_step"],
            "ms_per_step_ranks": [g["ms_per_step"] for g in got],
            "collectives_ranks": [g["collectives"] for g in got]}
    out["adafactor"] = ma_adafactor_check(card, ft_inp, one_ada, [r["adafactor"] for r in ranks])
    dry = [r["dryrun"] for r in ranks]
    if not (all(abs(d["loss"] - dry[0]["loss"]) <= 1e-5 * abs(dry[0]["loss"]) for d in dry)
            and np.isfinite(dry[0]["finetune_loss"]) and dry[0]["mesh"] == (world // 2, 2)):
        raise AssertionError(f"model axis, dryrun_multichip: {dry}")
    out["dryrun"] = dry[0]
    out["seconds"] = round(time.time() - t0, 2)
    emit(out)
    return out




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
    rows_out.update(phase_stem_kernel())
    data = phase_data()
    phase_native_gather(card, data)
    # wiped first: auto-resume would otherwise continue a previous run's checkpoints
    pretrain_out = ROOT / "build" / "smoke_pretrain_out"
    shutil.rmtree(pretrain_out, ignore_errors=True)
    for sparse_impl, block_impl in SLICES:
        phase_slice(rows_out, card, sparse_impl, block_impl, data,
                    pretrain_out if block_impl == "wholeblock" else None)
    for sparse_impl, block_impl, options in OPTION_SLICES:
        phase_slice(rows_out, card, sparse_impl, block_impl, data, options=options)
    data128 = phase_data("smoke_data128", n=292, tile=128)
    phase_slice(rows_out, card, "gathered", "wholeblock", data128, config=PICO112)
    orig_out = ROOT / "build" / "smoke_orig_stem_out"
    shutil.rmtree(orig_out, ignore_errors=True)
    phase_slice(rows_out, card, "gathered", "wholeblock", data128, orig_out, PICO112,
                {"use_orig_stem": True})
    geobench = phase_geobench_data()
    for probe in (False, True):
        phase_finetune(rows_out, card, geobench, pretrain_out / "checkpoint-2.pth", probe)
    phase_finetune(rows_out, card, geobench, orig_out / "checkpoint-2.pth", False, PICO112,
                   {"use_orig_stem": True})
    seg_out = ROOT / "build" / "smoke_seg_pretrain_out"
    shutil.rmtree(seg_out, ignore_errors=True)
    phase_slice(rows_out, card, "gathered", "wholeblock", data128, seg_out, ATTO112)
    cashew, cashew64 = phase_seg_data()
    phase_seg(rows_out, card, cashew, seg_out / "checkpoint-3.pth")
    phase_finetune_lamb(card, seg_out / "checkpoint-3.pth")
    phase_baselines(card, geobench, cashew64)
    for sparse_impl, block_impl in (("gathered", "wholeblock"), ("masked_dense", "fused")):
        phase_graph(card, sparse_impl, block_impl)
    phase_graph(card, "gathered", "wholeblock", PICO112, update_freq=2)
    for sparse_impl, block_impl, options in OPTION_SLICES:
        phase_graph(card, sparse_impl, block_impl, options=options)
    phase_graph(card, "gathered", "wholeblock", PICO112, options={"use_orig_stem": True})
    phase_cli_graph(card, data)
    bench_line = phase_bench(card)
    phase_bench(card, "seg")
    phase_gate()
    phase_tools(card, data, pretrain_out / "checkpoint-2.pth", bench_line)
    phase_distributed(card, data, geobench, pretrain_out / "checkpoint-2.pth",
                      ROOT / "build" / "smoke_foreign")
    phase_model_axis(card)
    for sparse_impl, block_impl in (("gathered", "dwg"), ("gathered", "wholeblock"),
                                    ("masked_dense", "fused")):
        phase_reference(sparse_impl, block_impl)
    pico = (112, 16, (64, 128, 256, 512), (1, 1, 1, 1))
    phase_reference("gathered", "wholeblock", *pico)
    for sparse_impl, block_impl, options in (
            *OPTION_SLICES, ("gathered", "wholeblock", {"use_orig_stem": True}),
            ("gathered", "wholeblock", {"stem_gathered": True}),
            ("gathered", "wholeblock", {"stem_gathered": True, "use_orig_stem": True})):
        phase_reference(sparse_impl, block_impl, **options)
    phase_reference("gathered", "wholeblock", *pico, use_orig_stem=True)
    phase_reference_classifier()
    phase_families(card)
    phase_reference_seg()
    phase_orbax(card, geobench, pretrain_out / "checkpoint-2.pth")
    phase_optional_packages(card)
    print(card, flush=True)
    emit({"kernels": list(rows_out.values())})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == DIST_CHILD:
        sys.path.insert(0, str(ROOT))
        sys.exit(dist_child(sys.argv[2], sys.argv[3], sys.argv[4:]))
    sys.exit(main())

#!/usr/bin/env python3
"""Times the spill-g block-tail launches of one checkout of the PyTorch port
at the atto-56/8 stage shapes, or with ``--patch`` its patch gather and
scatter launches, so that two checkouts can be compared on one card.

    python3 scripts/torch_launch_ab.py [--root DIR] [--iters 100] [--ptxas] [--c2816] [--pico]
    python3 scripts/torch_launch_ab.py --patch [--root DIR] [--iters 100] [--ptxas]

``--root`` is the root of the checkout whose ``mmearth_tpu_torch`` is timed
(default: this one); its kernels are built into its own ``build/kernels``.
The inputs are those of ``chip_smoke.py``'s spill-g phase: bf16 rows of
batch 256, 19 of 49 patches visible, one GRN group, at the four stages
(p, C) = (8, 40), (4, 80), (2, 160), (1, 320), each launch on the plain
outputs of the phases before it.  For each launch and stage, two times:
``call_ms``, the median of CUDA-event windows around one call (as
``chip_smoke.py`` times a launch: the window also holds the host work of the
call whenever the card waits for the host), ``stream_ms``, one window around
``--iters`` calls back to back divided by their number (the card's time a
call once the host runs ahead of it), and ``host_ms``, the host's time a
call in that loop (the wrapper's work and the enqueue).  Prints one JSON line with
both per stage and summed over a step (2/2/6/2 blocks a stage).  C is timed
as one call: its launch, and its dW2 pass where dW2 does not fold; the
backward's weights (``BwdWeights``) are made outside the timed calls.
``--c2816`` adds huge's last stage (C = 2816, the
4,864 rows of a batch-256 step) and ``--pico`` pico-112/16's stage 3 (C =
512, the 4,864 rows of a batch-64 step) as further shapes, not counted in
the step.  With ``--ptxas`` the
line also holds the registers, spill bytes and static shared memory that
``nvcc -Xptxas -v`` reports for every instance of the A, B, C and dv kernels
(A: the statistic pass) of the checkout's ``csrc/fused_block.cu`` (with
``--patch``: of the copy kernels of its ``csrc/patch_select.cu``).

``--patch`` times the eight gather/scatter launches of a gathered step
instead: at atto-56/8 (batch 256) and pico-112/16 (batch 64), 19 of 49
patches visible, bf16, the stem's gather and the stage-3 gather (the final
scatter's VJP), the stage-3 scatter and the stem's scatter (the gather's
VJP).  Beside ``call_ms``, ``stream_ms`` and ``host_ms`` (warm: the same
input back to back) each launch gets two device times from
``chip_smoke.py``'s timers (this checkout's, whatever ``--root`` is):
``cold_ms``, calls on distinct copies of the input with L2 flushed
(``cold_device_ms``), and ``warm_ms``, ``--iters`` calls on one input
after a first call (``device_window_ms``), as a step's repeated launches
would find L2 at best.  Sums over a step (2 + 2 launches at each
configuration) and each launch's byte bound at 3.35 TB/s are given beside.
``memcpy_cold_ms`` is one contiguous ``copy_`` of the same bytes (half
read, half written) timed as ``cold_ms``: the rate at which the card copies
memory in practice, a yardstick beside the bound.  Further cold times, not
counted in the step, ask why a launch takes its time: for each launch
``register_cold_ms``, the same launch on an input whose base lies 8 bytes
into its buffer (the register path at 8-byte vectors, where the plan's
rule sends such a pointer); for the stem scatter, the same launch under
three other masks: ``runs_cold_ms``, the grid's first 19 patches visible
(the same bytes, the masked rows in one run a sample against runs that
alternate every row or two under the random mask), ``all_kept_cold_ms``,
every patch visible (loads only, no zero row), and ``none_kept_cold_ms``,
none visible (zero rows only, no load).  Needs a CUDA GPU; it imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, GRID, K = 256, 7, 19
STAGES = ((8, 40, 2), (4, 80, 2), (2, 160, 6), (1, 320, 2))  # (p, C, blocks a step)
# (configuration, batch, (p, C) of the stem, (p, C) of stage 3) of the gathered steps
PATCH_CONFIGS = (("atto56_8", 256, (8, 40), (1, 320)), ("pico112_16", 64, (16, 64), (2, 512)))
HBM_BYTES_PER_S = 3.35e12


def call_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream_ms(torch, fn, iters):
    """(card ms, host ms) a call of ``iters`` calls back to back."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters, host


def patch_launches(ps, torch, gen, n, stem, stage3, kept, inv):
    """The four gather/scatter launches of one gathered configuration under
    the mask of ``kept``/``inv``: name -> (the call on a given input, the
    input's maker, the bytes the launch moves once, the input's bytes, the
    launch's plan where the checkout has one)."""
    dev, bf, k = gen.device, torch.bfloat16, kept.shape[1]
    plan = getattr(ps, "launch_plan", None)
    out = {}
    for where, (p, c) in (("stem", stem), ("stage3", stage3)):
        h = GRID * p
        dense, rows = n * h * h * c * 2, n * k * p * p * c * 2
        out[f"gather_{where}"] = (
            lambda x, p=p: ps._gather(x, kept, p, GRID),
            lambda h=h, c=c: torch.randn(n, h, h, c, generator=gen, device=dev).to(bf),
            2 * rows + kept.numel() * 4, dense,
            plan and (lambda x, p=p: plan(x, kept, p, GRID, False)))
        out[f"scatter_{where}"] = (
            lambda xg, p=p, h=h: ps._scatter(xg, kept, inv, p, GRID, h),
            lambda p=p, c=c: torch.randn(n, k, p, p, c, generator=gen, device=dev).to(bf),
            rows + dense + inv.numel() * 4, rows,
            plan and (lambda xg, p=p: plan(xg, inv, p, GRID, True)))
    return {k: out[k] for k in ("gather_stem", "gather_stage3", "scatter_stage3", "scatter_stem")}


def offset8(torch, make):
    """``make``'s input, copied to a base 8 bytes into a larger buffer."""
    def made():
        x = make()
        extra = 8 // x.element_size()
        y = torch.empty(x.numel() + extra, dtype=x.dtype, device=x.device)[extra:]
        return y.view(x.shape).copy_(x)
    return made


def time_patch(args, torch, smoke) -> dict:
    """Per configuration of ``PATCH_CONFIGS``: each launch's times, bound
    and plan, and their sums over a step (each launch runs once a step)."""
    from mmearth_tpu_torch.models.convnextv2 import visible_ids
    from mmearth_tpu_torch.models.fcmae import gen_random_mask
    from mmearth_tpu_torch.ops import patch_select as ps

    gen = torch.Generator(device="cuda").manual_seed(2)
    configs = {}
    for name, n, stem, stage3 in PATCH_CONFIGS:
        kept, inv = visible_ids(gen_random_mask(n, GRID * GRID, 0.6, gen, gen.device), K)
        first = torch.ones(n, GRID * GRID, device=gen.device)
        first[:, :K] = 0  # the first K patches visible: the masked rows in one run a sample
        probes = {probe: patch_launches(ps, torch, gen, n, stem, stage3,
                                        *visible_ids(mask, visible))["scatter_stem"]
                  for probe, mask, visible in (
                      ("runs", first, K), ("all_kept", torch.zeros_like(first), GRID * GRID),
                      ("none_kept", torch.ones_like(first), 0))}
        times, step = {}, {}
        for key, (fn, make, nbytes, in_bytes, plan) in patch_launches(
                ps, torch, gen, n, stem, stage3, kept, inv).items():
            x = make()
            one = lambda fn=fn, x=x: fn(x)  # noqa: E731
            card, host = stream_ms(torch, one, args.iters)
            cold = smoke.cold_device_ms(fn, make, in_bytes)
            one()
            warm = smoke.device_window_ms([one] * args.iters, keep=False)
            # a yardstick of what the card copies: one contiguous copy of the same bytes
            pairs = [(torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda"),
                      torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda"))
                     for _ in range(max(4, math.ceil(100e6 / nbytes)))]
            flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
            memcpy = smoke.device_window_ms([lambda d=d, s=s: d.copy_(s) for d, s in pairs],
                                            flush)
            del pairs, flush
            t = {"call_ms": call_ms(torch, one, args.iters), "stream_ms": card, "host_ms": host,
                 "cold_ms": cold, "warm_ms": warm, "memcpy_cold_ms": memcpy,
                 "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
                 "register_cold_ms": smoke.cold_device_ms(fn, offset8(torch, make), in_bytes)}
            if key == "scatter_stem":
                for probe, (pfn, pmake, _, pin, _) in probes.items():
                    # an empty input (none visible): four calls a window
                    t[f"{probe}_cold_ms"] = smoke.cold_device_ms(pfn, pmake, pin or 25e6)
            if plan:
                t["plan"] = plan(x)._asdict()
                t["register_plan"] = plan(offset8(torch, make)())._asdict()
            times[key] = t
            for k in ("call_ms", "stream_ms", "host_ms", "cold_ms", "warm_ms", "memcpy_cold_ms",
                      "bound_ms"):
                step[k] = step.get(k, 0.0) + t[k]
            torch.cuda.empty_cache()
        configs[name] = {"batch": n, "launches": times, "per_step": step}
    return configs


def launches(fb, torch, gen, m, c):
    """The spill-g launches on seeded inputs of (m, C) rows."""
    dev, bf, c4 = gen.device, torch.bfloat16, 4 * c

    def rnd(*shape, s=1.0, mean=0.0):
        return mean + s * torch.randn(*shape, generator=gen, device=dev)

    t, x, dy = rnd(m, c).to(bf), rnd(m, c).to(bf), rnd(m, c).to(bf)
    lw, lb, b1, b2 = rnd(c, s=0.1, mean=1.0), rnd(c, s=0.1), rnd(c4, s=0.1), rnd(c, s=0.1)
    w1, w2 = rnd(c4, c, s=c ** -0.5), rnd(c, c4, s=c4 ** -0.5)
    gm, bt = rnd(c4, s=0.5), rnd(c4, s=0.1)
    g, gxsq = fb.fwd_a_plain(t, lw, lb, w1, b1, m)
    _, gx, nx = fb.fwd_b_plain(g, x, gxsq, gm, bt, w2, b2, m)
    out = {"spillg_fwd_a": lambda: fb._fwd_a_cuda(t, lw, lb, w1, b1, m),
           "spillg_fwd_b": lambda: fb._fwd_b_cuda(g, x, gxsq, gm, bt, w2, b2, m)}
    wts, rwts = fb._bwd_weights_cuda(w1, w2, bf), fb.bwd_weights_plain(w1, w2, bf)
    dgxg = fb.dgx_step(fb.bwd_c_plain(dy, g, nx, gm, bt, rwts, m)[3], gx)
    d_args = (t, dy, g, nx, dgxg, lw, lb, wts, b1, gm, m)
    dv, u = fb.bwd_d_plain(t, dy, g, nx, dgxg, lw, lb, rwts, b1, gm, m)[4:]
    out["spillg_bwd_c"] = lambda: fb._bwd_c_cuda(dy, g, nx, gm, bt, wts, m)
    out["spillg_bwd_d"] = lambda: fb._bwd_d_cuda(*d_args)
    out["spillg_bwd_d_dw1"] = lambda: fb._dw1_cuda(dv, u)
    return out


def ptxas(build, root: Path, source: str, kernels: str) -> list:
    """-Xptxas -v of the checkout's ``csrc/<source>.cu``: the registers,
    spill bytes and static shared memory of each kernel instance whose
    mangled name matches ``kernels``."""
    out = root / "build" / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / f"{source}.so"),
           str(root / "mmearth_tpu_torch" / "csrc" / f"{source}.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr.splitlines()
    found, cur = [], None
    for line in log:
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            cur = {"kernel": entry.group(1)} if re.search(kernels, entry.group(1)) else None
            if cur is not None:
                found.append(cur)
        elif cur is not None and "spill stores" in line:
            cur["spill"] = line.strip()
        elif cur is not None and "Used" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(smem.group(1)) if smem else 0
    return found


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--c2816", action="store_true", help="also time huge's last stage")
    ap.add_argument("--pico", action="store_true", help="also time pico-112/16's stage 3")
    ap.add_argument("--patch", action="store_true",
                    help="time the patch gather/scatter launches instead")
    args = ap.parse_args()
    # chip_smoke.py's timers from this checkout, imported before --root's package
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from mmearth_tpu_torch.ops import _build
    from mmearth_tpu_torch.ops import fused_block as fb

    if not torch.cuda.is_available():
        print("torch_launch_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    if args.patch:
        line = {"root": str(root), "card": torch.cuda.get_device_name(0), "iters": args.iters,
                "configs": time_patch(args, torch, chip_smoke)}
        if args.ptxas:
            line["ptxas"] = ptxas(_build, root, "patch_select", r"patch_copy")
        print(json.dumps(line), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    stages, step = [], {}
    shapes = [(N * K * p * p, c, count) for p, c, count in STAGES]
    shapes += [(64 * K * 4, 512, 0)] if args.pico else []
    for m, c, count in shapes + ([(N * K, 2816, 0)] if args.c2816 else []):
        times = {}
        for key, fn in launches(fb, torch, gen, m, c).items():
            card, host = stream_ms(torch, fn, args.iters if c < 2816 else 5)
            times[key] = {"call_ms": call_ms(torch, fn, args.iters if c < 2816 else 5),
                          "stream_ms": card, "host_ms": host}
            for k, v in times[key].items():
                step.setdefault(key, {}).setdefault(k, 0.0)
                step[key][k] += count * v
        stages.append({"shape": [m, c], "per_step": count, "times": times})
        torch.cuda.empty_cache()
    line = {"root": str(root), "card": torch.cuda.get_device_name(0), "iters": args.iters,
            "per_step": step, "stages": stages}
    if args.ptxas:
        line["ptxas"] = ptxas(_build, root, "fused_block",
                              r"spillg_(bwd_[cd]|fwd_b)_kernel|bwd_dv_kernel|fwd_stat_kernel")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

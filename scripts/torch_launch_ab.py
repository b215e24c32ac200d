#!/usr/bin/env python3
"""Times the spill-g block-tail launches of one checkout of the PyTorch port
at the atto-56/8 stage shapes, so that two checkouts can be compared on one
card.

    python3 scripts/torch_launch_ab.py [--root DIR] [--iters 100] [--ptxas] [--c2816]

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
4,864 rows of a batch-256 step) as a fifth shape, not counted in the step.  With ``--ptxas`` the
line also holds the registers, spill bytes and static shared memory that
``nvcc -Xptxas -v`` reports for every instance of the C and dv kernels of the
checkout's ``csrc/fused_block.cu``.  Needs a CUDA GPU; it imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, GRID, K = 256, 7, 19
STAGES = ((8, 40, 2), (4, 80, 2), (2, 160, 6), (1, 320, 2))  # (p, C, blocks a step)


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


def ptxas(build, root: Path) -> list:
    """-Xptxas -v of the checkout's fused_block.cu: each C and dv kernel
    instance's registers, spill bytes and static shared memory."""
    out = root / "build" / "ptxas"
    out.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(out / "fused_block.so"),
           str(root / "mmearth_tpu_torch" / "csrc" / "fused_block.cu")]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr.splitlines()
    found, cur = [], None
    for line in log:
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            cur = ({"kernel": entry.group(1)}
                   if re.search(r"spillg_bwd_[cd]_kernel|bwd_dv_kernel", entry.group(1)) else None)
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
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    from mmearth_tpu_torch.ops import _build
    from mmearth_tpu_torch.ops import fused_block as fb

    if not torch.cuda.is_available():
        print("torch_launch_ab: needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    stages, step = [], {}
    shapes = [(N * K * p * p, c, count) for p, c, count in STAGES]
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
        line["ptxas"] = ptxas(_build, root)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The pretraining driver's ms/step with and without a process group, in turns.

    python3 scripts/torch_dist_ab.py [--pairs 2] [--epochs 6]

On one GPU: ``mmearth_tpu_torch.main_pretrain.main`` at atto56
``wholeblock``, batch 256, bf16, ``--steps_per_dispatch 4`` (one replay of a
captured 4-step graph an epoch of 4 steps) on ``chip_smoke.py``'s synthetic
data (``build/smoke_data``), run by ``chip_smoke.py``'s ``--dist-child``
mode under ``torchrun --standalone --nproc_per_node 1`` (an NCCL group of
one rank, its all-reduces captured in the graph) and in a plain process,
in the order G, A, A, G for each pair, both with this process's
``OMP_NUM_THREADS``.  Prints one JSON line a run (each epoch's ms/step
after the first, which captures, and the steps' losses' largest
difference from the first run's) and a summary line last.  The kernels
are built first (``chip_smoke.phase_build``).  Needs a CUDA GPU; it imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=6)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_dist_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    cs.phase_build()
    data = cs.phase_data()
    model_name, size, patch, batch = cs.ATTO56
    flags = ["--model", model_name, "--input_size", str(size), "--patch_size", str(patch),
             "--batch_size", str(batch), "--use_bf16", "True", "--device", "cuda",
             "--processed_dir", str(data), "--epochs", str(args.epochs), "--warmup_epochs", "1",
             "--seed", "0", "--block_impl", "wholeblock", "--steps_per_dispatch",
             str(cs.DIST_STEPS_PER_DISPATCH), "--distributed", "True"]
    runs = {"group": [], "alone": []}
    first = None
    for i in range(args.pairs):
        for mode in ("group", "alone", "alone", "group"):
            res = cs.run_child("pretrain", flags, mode == "group", f"ab_{mode}")
            losses = [x for e in res["history"] for x in e["step_losses"]]
            first = first or losses
            epoch_ms = [1e3 * e["seconds"] / e["steps"] for e in res["history"][1:]]
            runs[mode].append(cs.steady_ms(res["history"]))
            cs.emit({"pair": i, "mode": mode, "world": res["world"], "backend": res["backend"],
                     "epoch_ms_per_step": epoch_ms, "ms_per_step": runs[mode][-1],
                     "worst_loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, first)),
                     "process_seconds": res["process_seconds"]})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    cs.emit({"summary": True, "ms_per_step": runs,
             "median_group": statistics.median(runs["group"]),
             "median_alone": statistics.median(runs["alone"]), "card": card})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the benchmark once, on this machine's card.

    python3 benchmark/run.py --workload atto56.pretrain.resident --seed 7 \
        --seconds 30 --trace 0

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (a profiler trace of part of the window) with a
breakdown.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` when traced) and ``checks``, each compared number beside its
limit, which also end standard error.  Without a CUDA card, or with fewer
cards than the cell asks for, it exits with 2 and prints no result; any
other failure exits with 1 and prints no result.

The program's kernel builds stay in the checkout (``build/kernels``, the
program's own fixed place), the benchmark's pack and traces in
``benchmark/cache``; Triton's and PyTorch's extension caches are pointed
there too.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE = BENCH_DIR / "cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.spec import Cell

    cell = Cell(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    from harness import cell as runner

    out, counts = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                             T_START, log)
    log(f"card: {runner.power_limit()}")  # after the window: nvidia-smi is no set-up
    forbidden = sorted(set(counts["forbidden"]) | set(runner.forbidden_modules()))
    if forbidden:
        log(f"the run loaded {forbidden}, which the benchmark must not: no result")
        return 1
    log(json.dumps({k: v for k, v in counts.items() if k not in ("forbidden",)}))
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

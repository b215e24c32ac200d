#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on the card,
in one process (the benchmark's own runs never run this).

    python3 benchmark/calibrate.py --workload atto56.pretrain.resident \
        --seeds 1,2,...,12 --control_seeds 101,102,103 --out FILE

For each of ``--seeds``: the program's first dispatch at the cell's own
size, as a run's set-up drives it, then the reference: the compared numbers
of a sound run (the lower readings).  For each of ``--control_seeds``, the
same and then, each in the program's place, the control (the reference with
its products in float8, one precision step below the configuration's
bfloat16) and the faults a training cell can have on one card: half of the
batch left out (the mean over the rest) and a step that leaves its state
unchanged.  One JSON line a seed, to standard output and ``--out``; with
``--detail`` also each run's per-leaf norms and the worst leaves.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control_seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--detail", action="store_true", help="the worst leaves of each number")
    args = ap.parse_args(argv)

    import torch

    from harness.cell import Started, reference_numbers
    from harness.spec import Cell
    from reference.precision import Precision

    cell = Cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    n = cell.traffic["batch"]
    control = {"control_fp8": {"pr": Precision("fp8")},
               "fault_half_batch": {"rows": slice(0, n // 2)},
               "fault_state_unchanged": {"keep_state": True}}
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    with open(args.out or os.devnull, "a") as out:
        for seed, with_control in plan:
            t0 = time.perf_counter()
            st = Started(cell, seed, device, False)
            t1 = time.perf_counter()
            st.free(device)
            found, ref = reference_numbers(cell, st, control if with_control else None,
                                           args.detail)
            line = {"workload": args.workload, "seed": seed, "program_s": t1 - t0,
                    "reference_s": time.perf_counter() - t1, "losses": st.prog["losses"],
                    "ref_losses": ref["losses"], **found}
            if args.detail:
                line.update(program_norms=st.prog, reference_norms=ref)
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
            out.flush()
            del st, ref
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Host-side rate of the mmpack row gather: the native core
(``mmearth_tpu_torch/data/native``) at several thread counts (``native_<n>``,
the core itself at n threads whatever the size; ``native_loader``, the
loader's call at the drivers' 10, ``threads_for``'s rule) against the plain
numpy gather
(``np.take``), per field and for a whole batch, and the cost of the loader's
readahead hint (``PackedDataset.prefetch``) over the same epoch.

    python3 scripts/torch_gather_bench.py [--n_samples 4096] [--batch 256]

Writes the atto56 bench's synthetic pack (64-px tiles, the 12 default
modalities) under ``build/gather_bench``, reads it once so every page of the
memory map is resident, then gathers one shuffled epoch (each batch's rows
sorted, as the loader sorts them), best of 3 passes, into pinned buffers on
a machine with CUDA (into ordinary ones elsewhere).  Prints one JSON line a
measurement and a summary line last; every line names the host's cores and,
where there is one, the card."""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mmearth_tpu_torch.data import native  # noqa: E402
from mmearth_tpu_torch.data.loader import PackedDataset, PackedLoader, pinned_empty  # noqa: E402
from mmearth_tpu_torch.data.synthetic import generate_packed  # noqa: E402

THREADS = (1, 2, 4, 8, 0)  # 0: one a core
LOADER_THREADS = 10  # the drivers' --num_workers default


def card() -> str | None:
    if not torch.cuda.is_available():
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def best_seconds(fn, passes: int = 3) -> float:
    best = float("inf")
    for _ in range(passes):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n_samples", type=int, default=4096)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--out", default=str(ROOT / "build" / "gather_bench"))
    args = p.parse_args(argv)
    pin = torch.cuda.is_available()
    where = {"host_cores": os.cpu_count(), "pinned": pin, "card": card()}
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    generate_packed(out, n=args.n_samples, tile=64, seed=0, splits=("train",))
    ds = PackedDataset(out / "train")
    batches = [np.ascontiguousarray(np.sort(r), dtype=np.int64)
               for r in PackedLoader(ds, batch_size=args.batch, seed=0)._epoch_batches()]
    n = len(batches) * args.batch
    for arr in ds.arrays.values():  # every page of the map resident
        np.asarray(arr).sum()
    bufs = [{k: (pinned_empty if pin else np.empty)((len(r), *a.shape[1:]), a.dtype)
             for k, a in ds.arrays.items()} for r in batches]
    view = (lambda t: t.numpy()) if pin else (lambda t: t)

    def run(gather, fields):
        for rows, b in zip(batches, bufs):
            for k in fields:
                gather(ds.arrays[k], rows, view(b[k]))

    lib = native.get_lib()

    def forced(t):  # the core itself at exactly t threads (0: one a core)
        return lambda a, r, o: lib.mm_gather_rows(a.ctypes.data, o.ctypes.data, a[0].nbytes,
                                                  r.ctypes.data, len(r), t)

    methods = {"numpy": lambda a, r, o: native.take_rows(a, r, out=o),
               **{f"native_{t or 'auto'}": forced(t) for t in THREADS},
               "native_loader": lambda a, r, o: native.gather_rows(a, r, out=o,
                                                                   n_threads=LOADER_THREADS)}
    summary = {}
    for field, arr in [("all", None), *ds.arrays.items()]:
        fields = list(ds.arrays) if field == "all" else [field]
        row_bytes = sum(ds.arrays[k][0].nbytes for k in fields)
        line = {"field": field, "row_bytes": row_bytes, "batch": args.batch, "samples": n}
        if field != "all":
            line["loader_threads"] = native.threads_for(row_bytes * args.batch, LOADER_THREADS)
        for name, gather in methods.items():
            s = best_seconds(lambda: run(gather, fields))
            line[f"{name}_sps"] = n / s
            line[f"{name}_gbps"] = n * row_bytes / s / 1e9
        print(json.dumps({**line, **where}), flush=True)
        if field == "all":
            summary = line
    hint = best_seconds(lambda: [ds.prefetch(r) for r in batches])
    # a contiguous copy of the same bytes: the host's practical copy rate
    src = np.asarray(ds.arrays["sentinel2"])[: args.batch]
    dst = view(bufs[0]["sentinel2"])
    s = best_seconds(lambda: np.copyto(dst, src), passes=5)
    result = {**summary, "contiguous_copy_gbps": src.nbytes / s / 1e9,
              "readahead_hint_ms_per_batch": 1e3 * hint / len(batches), **where}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

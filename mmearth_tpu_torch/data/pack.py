"""Offline packer: MMEarth HDF5 (or any map-style dataset of sample dicts)
-> flat memory-mapped tensors ("mmpack"); port of ``mmearth_tpu/data/pack.py``.

The FFCV-beton equivalent (reference mmearth_dataset.py:252-318,321-373): all
per-sample transforms (band select, label remap, z-norm, dtype cast, HWC
layout) run once offline; the training loader then does nothing but gather
rows from memory-mapped files.

Layout of a packed split directory::

    <out>/meta.json          {"count": N, "fields": {name: {shape, dtype}}}
    <out>/<field>.bin        .npy-format [N, *shape] array (int64 stored int32)
    <out>/ids.json           the items' ids

    python -m mmearth_tpu_torch.data.pack --data_dir <MMEarth dir> --out <dir> \\
        [--splits train val] [--modalities default|rgb|inp_only]

Reading the HDF5 needs ``h5py``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np

from .mmearth import MMEarthDataset

CHUNK = 256  # rows a batched read (MMEarthDataset.get_rows)


def pack_split(items, out_dir: Path | str, indices: Sequence[int] | None = None,
               log_every: int = 10000) -> Path:
    """Write every item of ``items`` (a map-style dataset of dicts of numpy
    arrays plus an ``id`` string; ``indices`` picks a subset) under
    ``out_dir``.  A dataset with ``get_rows`` (the HDF5 reader) is read
    ``CHUNK`` rows at a time."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    idxs = list(range(len(items))) if indices is None else list(indices)
    n = len(idxs)
    if n == 0:
        raise ValueError("cannot pack an empty split")
    fields, writers = {}, {}
    for name, arr in items[idxs[0]].items():
        if name == "id":
            continue
        arr = np.asarray(arr)
        dtype = np.int32 if arr.dtype == np.int64 else arr.dtype
        fields[name] = {"shape": list(arr.shape), "dtype": np.dtype(dtype).name}
        writers[name] = np.lib.format.open_memmap(
            out_dir / f"{name}.bin", mode="w+", dtype=dtype, shape=(n, *arr.shape))
    ids = []
    if hasattr(items, "get_rows"):
        idxs, logged = np.asarray(idxs), 0
        for start in range(0, n, CHUNK):
            pos = idxs[start:start + CHUNK]
            batch = items.get_rows(pos)
            ids.extend(batch.pop("id"))
            for name, arr in batch.items():
                writers[name][start:start + len(pos)] = arr
            written = start + len(pos)
            if log_every and written // log_every > logged:
                logged = written // log_every
                print(f"packed {written}/{n}")
    else:
        for row, idx in enumerate(idxs):
            item = dict(items[idx])
            ids.append(item.pop("id"))
            for name, arr in item.items():
                writers[name][row] = arr
            if log_every and row and row % log_every == 0:
                print(f"packed {row}/{n}")
    for w in writers.values():
        w.flush()
    (out_dir / "meta.json").write_text(json.dumps({"count": n, "fields": fields}))
    (out_dir / "ids.json").write_text(json.dumps(ids))
    return out_dir


def pack_mmearth(data_dir: Path | str, processed_dir: Path | str, modalities,
                 splits: Sequence[str] = ("train",),
                 indices: Sequence[Sequence[int]] | None = None) -> list[Path | None]:
    """Pack each split of the MMEarth HDF5 at ``data_dir`` under
    ``processed_dir/<split>`` (``<split>_subset`` with ``indices``) unless it
    is packed already, as the reference converts its betons lazily
    (mmearth_dataset.py:279-298).  An empty split other than train gives
    None."""
    out = []
    for i, split in enumerate(splits):
        dest = Path(processed_dir) / (split + ("_subset" if indices is not None else ""))
        if not (dest / "meta.json").exists():
            ds = MMEarthDataset(data_dir, modalities, split=split)
            if len(ds) == 0:
                if split == "train":
                    raise ValueError("training dataset has no samples")
                out.append(None)
                continue
            print(f"packing split {split!r} -> {dest}")
            pack_split(ds, dest, indices=None if indices is None else indices[i])
        out.append(dest)
    return out


def main(argv=None):
    import argparse

    from ..configs import modalities as M

    ap = argparse.ArgumentParser(description="Pack MMEarth HDF5 into mmpack format")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--splits", nargs="+", default=["train"])
    ap.add_argument("--modalities", choices=["default", "rgb", "inp_only"], default="default")
    args = ap.parse_args(argv)
    pack_mmearth(args.data_dir, args.out, M.modality_preset(args.modalities),
                 splits=args.splits)


if __name__ == "__main__":
    main()

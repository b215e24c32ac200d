"""Generic offline packer into the mmpack layout (port of the item loop of
``mmearth_tpu/data/pack.py::pack_split``; the MMEarth HDF5 reader and its
batched ``get_rows`` branch are not ported yet).

Layout of a packed split directory::

    <out>/meta.json          {"count": N, "fields": {name: {shape, dtype}}}
    <out>/<field>.bin        .npy-format [N, *shape] array (int64 stored int32)
    <out>/ids.json           the items' ids
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import numpy as np


def pack_split(items, out_dir: Path | str, indices: Sequence[int] | None = None,
               log_every: int = 10000) -> Path:
    """Write every item of ``items`` (a map-style dataset of dicts of numpy
    arrays plus an ``id`` string; ``indices`` picks a subset) under
    ``out_dir``."""
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

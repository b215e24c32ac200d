"""Synthetic MMEarth data: in the reference's HDF5 layout (:func:`generate`,
the arrays of ``mmearth_tpu/data/synthetic.py::generate``, drawn in the same
numpy order), or written straight to the mmpack layout (:func:`generate_packed`):
the same arrays put through the transforms of ``MMEarthDataset.get_rows``
(:func:`.mmearth.transform`: band selection, label remaps, no-data -> NaN,
per-band z-norm with the per-tile l2a/l1c sentinel2 statistics, categorical ->
int with -1 for NaN, NHWC) and written as :mod:`.pack` packs a split::

    <out>/<split>/meta.json        {"count": N, "fields": {name: {shape, dtype}}}
    <out>/<split>/<modality>.bin   .npy-format [N, *shape] array (labels int32)
    <out>/<split>/ids.json         tile names

So ``generate_packed`` gives, with no HDF5 in between, exactly what
``generate`` + ``pack_mmearth`` give.

    python -m mmearth_tpu_torch.data.synthetic --out <dir> --n 1170 --tile 64 [--hdf5]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from ..configs import modalities as M
from .mmearth import require_h5py, transform

_STATS = {  # the generator's band statistics: (mean, std, bands)
    "sentinel2_l2a": (2000, 800, 13),
    "sentinel2_l1c": (2100, 850, 13),
    "sentinel1": (-10, 4, 8),
    "aster": (500, 300, 2),
    "canopy_height_eth": (10, 10, 2),
    "era5": (280, 15, 12),
    "lat": (0, 0.7, 2),
    "lon": (0, 0.7, 2),
    "month": (0, 0.7, 2),
}
# as the generator's ``*_band_stats.json`` holds them
BAND_STATS = {key: {"mean": [float(mean)] * k, "std": [float(std)] * k}
              for key, (mean, std, k) in _STATS.items()}
_ESA_VALS = np.array([0, 10, 20, 30, 40, 50, 60, 70, 80, 90, 95, 100], dtype=np.uint8)


def raw_arrays(n: int, tile: int, seed: int) -> dict[str, np.ndarray]:
    """The raw (pre-transform, CHW) arrays, in the generator's draw order."""
    rng = np.random.default_rng(seed)
    raw = {
        "sentinel2": rng.normal(2000, 800, size=(n, 13, tile, tile)).astype(np.uint16),
        "sentinel1": rng.normal(-10, 4, size=(n, 8, tile, tile)).astype(np.float32),
        "aster": rng.normal(500, 300, size=(n, 2, tile, tile)).astype(np.float32),
    }
    canopy = rng.integers(0, 60, size=(n, 2, tile, tile)).astype(np.uint8)
    canopy[rng.random(canopy.shape) < 0.02] = 255
    raw["canopy_height_eth"] = canopy
    raw["dynamic_world"] = rng.integers(0, 10, size=(n, 1, tile, tile)).astype(np.uint8)
    raw["esa_worldcover"] = _ESA_VALS[rng.integers(0, len(_ESA_VALS), size=(n, 1, tile, tile))]
    era5 = rng.normal(280, 15, size=(n, 12)).astype(np.float32)
    era5[rng.random(era5.shape) < 0.05] = np.nan
    raw["era5"] = era5
    raw["lat"] = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    raw["lon"] = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    raw["month"] = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    raw["biome"] = np.eye(14, dtype=np.uint8)[rng.integers(0, 14, n)]
    raw["eco_region"] = np.eye(846, dtype=np.uint8)[rng.integers(0, 846, n)]
    return raw


def splits_of(n: int) -> dict[str, list[int]]:
    n_val = max(1, n // 8)
    return {"train": list(range(n - n_val)), "val": list(range(n - n_val, n))}


def transformed(raw: Mapping[str, np.ndarray], rows: Sequence[int]) -> dict[str, np.ndarray]:
    """The packed (transformed, NHWC) arrays of ``rows``, in modality order
    (the input modalities, then the output ones)."""
    modalities = {**M.INP_MODALITIES, **M.OUT_MODALITIES}
    rows = np.asarray(rows)
    l2a = rows % 2 == 0  # the generator's tile_info: even tiles are l2a
    band_idx = M.band_indices(modalities)
    out = {m: transform(m, raw[m][rows], band_idx[m], l2a, BAND_STATS) for m in modalities}
    return {m: v.astype(np.int32) if v.dtype == np.int64 else v for m, v in out.items()}


def synthetic_batch(n: int, tile: int, seed: int = 0) -> dict[str, np.ndarray]:
    """An in-memory batch of ``n`` transformed samples (default modalities)."""
    return transformed(raw_arrays(n, tile, seed), range(n))


def bench_batch(n: int, tile: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The i.i.d. batch the benchmark and the convergence gate train on: the
    arrays of ``__graft_entry__.py::_synthetic_batch``, drawn in its order
    (standard normals, categorical maps with -1 for no data, one-hot biome
    and eco-region), NHWC, no transform."""
    rng = np.random.default_rng(seed)
    return {
        "sentinel2": rng.normal(size=(n, tile, tile, 12)).astype(np.float32),
        "sentinel1": rng.normal(size=(n, tile, tile, 8)).astype(np.float32),
        "aster": rng.normal(size=(n, tile, tile, 2)).astype(np.float32),
        "canopy_height_eth": rng.normal(size=(n, tile, tile, 2)).astype(np.float32),
        "dynamic_world": rng.integers(-1, 9, size=(n, tile, tile, 1)).astype(np.int32),
        "esa_worldcover": rng.integers(-1, 11, size=(n, tile, tile, 1)).astype(np.int32),
        "era5": rng.normal(size=(n, 12)).astype(np.float32),
        "lat": rng.normal(size=(n, 2)).astype(np.float32),
        "lon": rng.normal(size=(n, 2)).astype(np.float32),
        "month": rng.normal(size=(n, 2)).astype(np.float32),
        "biome": np.eye(14, dtype=np.int32)[rng.integers(0, 14, n)],
        "eco_region": np.eye(846, dtype=np.int32)[rng.integers(0, 846, n)],
    }


def generate(out_dir: Path | str, n: int = 64, tile: int = 64, seed: int = 0,
             name: str = "data_synth") -> Path:
    """Write a synthetic MMEarth dataset in the reference's on-disk layout
    (mmearth_dataset.py:163-177): ``<name>.h5`` with a dataset per modality
    and ``metadata``, and the splits, tile-info and band-stats JSON files
    beside it.  Needs ``h5py``."""
    h5py = require_h5py()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    names = [f"tile_{i:06d}" for i in range(n)]
    with h5py.File(out_dir / f"{name}.h5", "w") as f:
        for modality, arr in raw_arrays(n, tile, seed).items():
            f[modality] = arr
        f["metadata"] = np.array([(s.encode(),) for s in names],
                                 dtype=np.dtype([("name", "S32")]))
    (out_dir / f"{name}_splits.json").write_text(json.dumps(splits_of(n)))
    tile_info = {s: {"S2_type": "l2a" if i % 2 == 0 else "l1c"} for i, s in enumerate(names)}
    (out_dir / f"{name}_tile_info.json").write_text(json.dumps(tile_info))
    (out_dir / f"{name}_band_stats.json").write_text(json.dumps(BAND_STATS))
    return out_dir


def generate_packed(out_dir: Path | str, n: int = 64, tile: int = 64, seed: int = 0,
                    splits: Sequence[str] = ("train", "val")) -> Path:
    """Write the mmpack splits of a synthetic dataset under ``out_dir``."""
    out_dir = Path(out_dir)
    raw = raw_arrays(n, tile, seed)
    names = [f"tile_{i:06d}" for i in range(n)]
    split_rows = splits_of(n)
    for split in splits:
        rows = split_rows[split]
        dest = out_dir / split
        dest.mkdir(parents=True, exist_ok=True)
        fields = {}
        for name, arr in transformed(raw, rows).items():
            fields[name] = {"shape": list(arr.shape[1:]), "dtype": arr.dtype.name}
            w = np.lib.format.open_memmap(dest / f"{name}.bin", mode="w+", dtype=arr.dtype,
                                          shape=arr.shape)
            w[:] = arr
            w.flush()
            del w
        (dest / "meta.json").write_text(json.dumps({"count": len(rows), "fields": fields}))
        (dest / "ids.json").write_text(json.dumps([names[i] for i in rows]))
    return out_dir


def main():
    ap = argparse.ArgumentParser(description="Write a synthetic MMEarth dataset as mmpack "
                                             "splits, or with --hdf5 in the HDF5 layout")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--tile", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hdf5", action="store_true", help="write the HDF5 layout (needs h5py)")
    args = ap.parse_args()
    write = generate if args.hdf5 else generate_packed
    print(f"wrote {write(args.out, n=args.n, tile=args.tile, seed=args.seed)}")


if __name__ == "__main__":
    main()

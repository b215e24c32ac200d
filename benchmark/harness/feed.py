"""The fed input path: an mmpack train split on disk, read by the port's
loader (``train/pretrain.py::get_dataloader`` with ``--loader mmpack``,
pinned, its native gather on ``num_workers`` threads), copied one batch
ahead by ``train/step.py::device_batches``, epoch after epoch.

The pack is written once per checkout into ``benchmark/cache/pack/`` by
:func:`write_pack`, the benchmark's copy of the program's synthetic
generator (``data/synthetic.py::generate_packed``: the MMEarth modalities
in their packed layout, z-normed continuous maps, no-data as NaN or -1,
one-hot biome and eco-region), from the traffic's fixed ``pack_seed``: every
run reads the same pack, and ``--seed`` draws the order.  Set-up reads it
through once, so the page cache is warm in every run.

The reference reads the first dispatch's rows from the same files in the
order the loader's documented shuffle gives (:func:`epoch_batches`).
"""
from __future__ import annotations

import itertools
import json
import shutil
from pathlib import Path

import numpy as np
import torch


TILE_FIELDS = (("sentinel2", 12), ("sentinel1", 8), ("aster", 2))
# the labels of ESA WorldCover's 12 values (0 no data, 10-100) after the packer's remap
ESA_LABELS = np.array([-1, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10])
# the pack's fields in the program's modality order (inputs, then outputs)
FIELDS = ("sentinel2", "sentinel1", "aster", "era5", "dynamic_world", "canopy_height_eth",
          "lat", "lon", "biome", "eco_region", "month", "esa_worldcover")
CHUNK = 512


def _chunk(rng, n: int, tile: int) -> dict[str, np.ndarray]:
    """``n`` packed samples, drawn from ``rng``."""
    out = {}
    for name, c in TILE_FIELDS:
        out[name] = rng.standard_normal((n, tile, tile, c), dtype=np.float32)
    canopy = rng.integers(0, 60, size=(n, tile, tile, 2)).astype(np.float32)
    canopy = (canopy - 10.0) / 10.0
    canopy[rng.random(canopy.shape) < 0.02] = np.nan
    out["canopy_height_eth"] = canopy
    dw = rng.integers(0, 10, size=(n, tile, tile, 1))
    out["dynamic_world"] = np.where(dw == 0, -1, dw - 1).astype(np.int32)
    out["esa_worldcover"] = ESA_LABELS[rng.integers(0, len(ESA_LABELS),
                                                    size=(n, tile, tile, 1))].astype(np.int32)
    era5 = rng.standard_normal((n, 12), dtype=np.float32)
    era5[rng.random(era5.shape) < 0.05] = np.nan
    out["era5"] = era5
    for name in ("lat", "lon", "month"):
        out[name] = (rng.uniform(-1, 1, size=(n, 2)) / 0.7).astype(np.float32)
    out["biome"] = np.eye(14, dtype=np.int32)[rng.integers(0, 14, n)]
    out["eco_region"] = np.eye(846, dtype=np.int32)[rng.integers(0, 846, n)]
    return out


def write_pack(dest: Path, n: int, tile: int, seed: int) -> Path:
    """The train split of ``n`` samples at ``dest`` (``meta.json`` last, so
    a split with it is whole)."""
    if (dest / "meta.json").exists():
        return dest
    tmp = dest.with_name(dest.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    files, fields = {}, {}
    for at in range(0, n, CHUNK):
        part = _chunk(rng, min(CHUNK, n - at), tile)
        for name in FIELDS:
            arr = part[name]
            if name not in files:
                fields[name] = {"shape": list(arr.shape[1:]), "dtype": arr.dtype.name}
                files[name] = np.lib.format.open_memmap(tmp / f"{name}.bin", mode="w+",
                                                        dtype=arr.dtype, shape=(n, *arr.shape[1:]))
            files[name][at:at + len(arr)] = arr
    for w in files.values():
        w.flush()
    del files
    (tmp / "ids.json").write_text(json.dumps([f"tile_{i:06d}" for i in range(n)]))
    (tmp / "meta.json").write_text(json.dumps({"count": n, "fields": fields}))
    dest.parent.mkdir(parents=True, exist_ok=True)
    shutil.rmtree(dest, ignore_errors=True)
    tmp.rename(dest)
    return dest


def warm(path: Path, block: int = 64 << 20) -> int:
    """Read every file of the split once; returns the bytes read."""
    total = 0
    for f in sorted(path.glob("*.bin")):
        with open(f, "rb") as fh:
            while chunk := fh.read(block):
                total += len(chunk)
    return total


def epoch_batches(n: int, batch: int, seed: int, epoch: int) -> list[np.ndarray]:
    """The rows of each batch of an epoch as the loader's documented shuffle
    gives them: a permutation from ``default_rng(seed + epoch)``, cut into
    whole batches, each batch's rows in ascending order."""
    idx = np.random.default_rng(seed + epoch).permutation(n)
    return [np.sort(idx[i * batch:(i + 1) * batch]) for i in range(n // batch)]


def pack_dir(cell) -> Path:
    t = cell.traffic
    return (cell.bench_dir / "cache" / "pack"
            / f"{cell.workload['config']}-{t['pack_samples']}-{t['pack_seed']}" / "train")


def make(cell, seed: int, batch: int, device, annotate: bool):
    """(Feed, the reference's first batches as a callable, the pack's bytes)."""
    from mmearth_tpu_torch.configs.config import DataConfig, PretrainConfig, RunConfig
    from mmearth_tpu_torch.train.pretrain import get_dataloader
    from mmearth_tpu_torch.train.step import device_batches

    from .cell import Feed

    t, tile = cell.traffic, cell.config["model"]["tile"]
    path = write_pack(pack_dir(cell), t["pack_samples"], tile, t["pack_seed"])
    nbytes = warm(path)
    cfg = PretrainConfig(data=DataConfig(data_dir=str(path.parent), batch_size=batch,
                                         num_workers=t["num_workers"], loader="mmpack"),
                         run=RunConfig(seed=seed))
    _, loader = get_dataloader(cfg, "train", pin_memory=torch.device(device).type == "cuda")

    def host_batches():
        for epoch in itertools.count():
            loader.set_epoch(epoch)
            yield from loader

    def first_batches():
        arrays = {name: np.load(path / f"{name}.bin", mmap_mode="r") for name in FIELDS}
        rows = (r for e in itertools.count()
                for r in epoch_batches(t["pack_samples"], batch, seed, e))
        k = t["steps_per_dispatch"]
        return [{name: torch.from_numpy(np.ascontiguousarray(a[r])).to(device)
                 for name, a in arrays.items()} for r in itertools.islice(rows, k)]

    return Feed(device_batches(host_batches(), device), annotate), first_batches, nbytes

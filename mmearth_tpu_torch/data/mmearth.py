"""MMEarth HDF5 dataset reader (port of ``mmearth_tpu/data/mmearth.py``).

Reproduces the reference ``MMEarthDataset.__getitem__`` transforms exactly
(mmearth_dataset.py:58-153), vectorised over a batch of rows
(:func:`transform`):

  * band selection against the full band lists (:71-77),
  * dynamic_world label remap 1..9 -> 0..8, no-data/>8 -> NaN (:88-97),
  * esa_worldcover remap 10,20,...,100 -> 0..10, no-data/>10 -> NaN (:99-107),
  * NO_DATA -> NaN for everything else (:109-114),
  * per-band z-normalization with the l1c/l2a sentinel2 stats chosen per tile
    (:116-135),
  * categorical modalities -> int (NaN -> -1), continuous -> float32
    (:137-143).

This reader is the offline path of the mmpack and ArrayRecord packers
(:mod:`.pack`, :mod:`.grain_pipeline`) and the online one of ``--loader
hdf5`` (:class:`HDF5StreamLoader`).  ``h5py`` is imported when a file is first
read, so the port imports where it is not installed.  Output layout is HWC.
"""
from __future__ import annotations

import json
import threading
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from ..configs import modalities as M
from .loader import PackedLoader, pin_batch


def require_h5py():
    """``h5py``, or an ImportError that names it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError("the MMEarth HDF5 reader (--loader hdf5, packing HDF5) needs h5py, "
                          "which is not installed") from e
    return h5py


def find_data_files(data_root: Path) -> dict[str, Path]:
    """Locate the four dataset files by glob (mmearth_dataset.py:163-177)."""
    data_root = Path(data_root)

    def one(pattern):
        matches = list(data_root.glob(pattern))
        if len(matches) != 1:
            raise FileNotFoundError(f"expected exactly one {pattern} at {data_root}, "
                                    f"got {matches}")
        return matches[0]

    return {
        "data": one("data_*.h5"),
        "splits": one("data_*_splits.json"),
        "tile_info": one("data_*_tile_info.json"),
        "band_stats": one("data_*_band_stats.json"),
    }


def transform(modality: str, raw: np.ndarray, sel: Sequence[int], l2a: np.ndarray,
              band_stats: Mapping) -> np.ndarray:
    """The reference's transform of one modality over a batch of raw (CHW)
    rows: ``sel`` its band indices, ``l2a`` marks the rows whose sentinel2 is
    l2a, ``band_stats`` the dataset's ``*_band_stats.json``.  Labels come out
    int64, the rest float32, image modalities NHWC."""
    data = np.array(raw, dtype=np.float64)
    if modality not in ("biome", "eco_region"):
        # one fancy index per read: rows in h5, bands in numpy
        data = data[:, sel, ...]
    no_data = M.NO_DATA_VAL[modality]
    if modality == "dynamic_world":
        data = np.where(data == no_data, np.nan, data)
        data = np.where((data >= 1) & (data <= 9), data - 1.0, data)
        data = np.where(data > 8, np.nan, data)
    elif modality == "esa_worldcover":
        data = np.where(data == no_data, np.nan, data)
        remapped = np.where(data == 95, 9.0, np.where(data == 100, 10.0, data / 10.0 - 1.0))
        data = np.where(np.isin(data, [10, 20, 30, 40, 50, 60, 70, 80, 90, 95, 100]), remapped, data)
        data = np.where(data > 10, np.nan, data)
    else:
        data = np.where(data == no_data, np.nan, data)

    if modality not in ("biome", "eco_region", "dynamic_world", "esa_worldcover"):
        def stat(key, which):
            return np.array(band_stats[key][which])[sel]

        if modality == "sentinel2":
            means = np.where(l2a[:, None], stat("sentinel2_l2a", "mean")[None],
                             stat("sentinel2_l1c", "mean")[None])  # (B, C)
            stds = np.where(l2a[:, None], stat("sentinel2_l2a", "std")[None],
                            stat("sentinel2_l1c", "std")[None])
        else:
            means = stat(modality, "mean")[None]
            stds = stat(modality, "std")[None]
        if modality in ("era5", "lat", "lon", "month"):
            data = (data - means) / stds
        else:
            data = (data - means[..., None, None]) / stds[..., None, None]

    if M.MODALITY_TASK[modality] in ("classification", "segmentation"):
        data = np.where(np.isnan(data), -1, data).astype(np.int64)
    else:
        data = data.astype(np.float32)
    if data.ndim == 4:
        data = np.ascontiguousarray(data.transpose(0, 2, 3, 1))
    return data


class MMEarthDataset:
    """Map-style reader over the MMEarth HDF5 (the file opened at first read,
    mmearth_dataset.py:52-62)."""

    def __init__(self, data_root: Path | str, modalities: Mapping[str, Sequence[str] | str],
                 split: str = "train"):
        files = find_data_files(Path(data_root))
        self.data_path = files["data"]
        with open(files["splits"]) as f:
            self.indices = json.load(f)[split]
        with open(files["tile_info"]) as f:
            self.tile_info = json.load(f)
        with open(files["band_stats"]) as f:
            self.band_stats = json.load(f)
        self.modalities = dict(modalities)
        self.band_idx = M.band_indices(self.modalities)
        self._h5 = None

    def __len__(self):
        return len(self.indices)

    def _file(self):
        if self._h5 is None:
            self._h5 = require_h5py().File(self.data_path, "r")
        return self._h5

    def __getitem__(self, idx: int) -> dict:
        out = self.get_rows(np.array([idx]))
        item = {k: v[0] for k, v in out.items() if k != "id"}
        item["id"] = out["id"][0]
        return item

    def get_rows(self, positions: np.ndarray) -> dict:
        """The samples at ``positions`` of the split (repeats allowed): one
        HDF5 read per modality for the whole batch, the transforms vectorised
        over it, plus their ``id``s."""
        positions = np.asarray(positions)
        f = self._file()
        rows = np.asarray(self.indices)[positions]
        # h5py fancy indexing wants increasing *unique* rows; `inverse` maps
        # each requested position back to its row in the deduped sorted read
        rows_sorted, inverse = np.unique(rows, return_inverse=True)
        names = [m[0].decode("utf-8") for m in f["metadata"][rows_sorted]]
        l2a = np.array([self.tile_info[n]["S2_type"] == "l2a" for n in names])
        out = {m: transform(m, f[m][rows_sorted, ...], self.band_idx[m], l2a,
                            self.band_stats)[inverse]
               for m in self.modalities}
        out["id"] = [names[i] for i in inverse]
        return out


class HDF5StreamLoader(PackedLoader):
    """Stream training batches straight from the HDF5 — the reference's
    ``no_ffcv`` DataLoader path (mmearth_dataset.py:273-277,
    main_pretrain.py:243-252): no packing step, the transforms run online on
    the host.  Shares PackedLoader's epoch shuffle, sharding, drop_last,
    prefetch and pinning; only the per-batch read differs, serialised by a
    lock (an h5py handle is not safe across the prefetch thread and
    stragglers).  Labels come out int32, as the packers store them."""

    def __init__(self, dataset: MMEarthDataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, shard: tuple[int, int] = (0, 1),
                 indices: Sequence[int] | None = None, prefetch: int = 2,
                 pin_memory: bool = False):
        super().__init__(dataset, batch_size, shuffle=shuffle, drop_last=drop_last, seed=seed,
                         shard=shard, indices=indices, prefetch=prefetch, pin_memory=pin_memory)
        self._read_lock = threading.Lock()

    def _prefetch_hint(self, rows: np.ndarray) -> None:
        pass  # no memmap to page in; the h5 chunk cache does its own thing

    def _gather_batch(self, rows: np.ndarray) -> dict:
        with self._read_lock:
            batch = self.dataset.get_rows(np.sort(rows))
        batch.pop("id")
        batch = {k: v.astype(np.int32) if v.dtype == np.int64 else v for k, v in batch.items()}
        return pin_batch(batch) if self.pin_memory else batch

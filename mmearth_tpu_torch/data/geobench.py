"""GEO-Bench data layer (port of ``mmearth_tpu/data/geobench.py``).

Mirrors the reference geobenchdataset.py: a thin wrapper over the
``geobench`` package for *offline* conversion (band selection in BAND_NAMES
order, per-band z-norm with the so2sat /10000 stat fix, label handling for
classification / multilabel / segmentation; :59-166), packed once into the
mmpack layout and served by the memory-mapped :class:`PackedLoader`.  The
``geobench`` package (and its downloaded data) is needed only for the
packing step; tests and ``chip_smoke.py`` use
:func:`generate_synthetic_geobench`.
"""
from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace
from typing import Sequence

import numpy as np

from .loader import PackedDataset, PackedLoader
from .pack import pack_split

GEOBENCH_TASK = {
    "m-eurosat": "classification",
    "m-so2sat": "classification",
    "m-bigearthnet": "classification",
    "m-brick-kiln": "classification",
    "m-cashew-plant": "segmentation",
    "m-SA-crop-type": "segmentation",
}

TASK_CLASS = {
    "m-eurosat": "classification",
    "m-so2sat": "classification",
    "m-bigearthnet": "multi_label_classification",
    "m-brick-kiln": "classification",
    "m-cashew-plant": "segmentation",
    "m-SA-crop-type": "segmentation",
}

NUM_CLASSES = {
    "m-eurosat": 10,
    "m-so2sat": 17,
    "m-bigearthnet": 43,
    "m-brick-kiln": 2,
    "m-cashew-plant": 7,
    "m-SA-crop-type": 10,
}

IMG_SIZE = {
    "m-eurosat": 64,
    "m-so2sat": 32,
    "m-bigearthnet": 120,
    "m-brick-kiln": 64,
    "m-cashew-plant": 256,
    "m-SA-crop-type": 256,
}

# Band-name tables (reference BAND_NAMES_v1_full.json / _bgr.json).  The 12
# "full" bands are the Sentinel-2 optical set; so2sat's sensor lacks B01/B09
# so Blue and B8A are repeated; brick-kiln's bgr set is stored red-first.
_S2_FULL = [
    "01 - Coastal aerosol", "02 - Blue", "03 - Green", "04 - Red",
    "05 - Vegetation Red Edge", "06 - Vegetation Red Edge",
    "07 - Vegetation Red Edge", "08 - NIR", "08A - Vegetation Red Edge",
    "09 - Water vapour", "11 - SWIR", "12 - SWIR",
]
_SO2SAT_FULL = [
    "02 - Blue", "02 - Blue", "03 - Green", "04 - Red",
    "05 - Vegetation Red Edge", "06 - Vegetation Red Edge",
    "07 - Vegetation Red Edge", "08 - NIR", "08A - Vegetation Red Edge",
    "08A - Vegetation Red Edge", "11 - SWIR", "12 - SWIR",
]
_BGR = ["02 - Blue", "03 - Green", "04 - Red"]

BAND_NAMES = {
    "full": {name: (_SO2SAT_FULL if name == "m-so2sat" else list(_S2_FULL))
             for name in GEOBENCH_TASK},
    "bgr": {
        name: (["04 - Red", "03 - Green", "02 - Blue"] if name == "m-brick-kiln" else list(_BGR))
        for name in GEOBENCH_TASK
    },
    "rgb": {name: list(reversed(_BGR)) for name in GEOBENCH_TASK},
}


def get_band_names(version: str = "1.0", geobench_bands_type: str = "full") -> dict:
    if version != "1.0":
        raise ValueError("only GEO-Bench v1.0 is supported (geobenchdataset.py:44-56)")
    return BAND_NAMES[geobench_bands_type]


def make_task_dict(dataset_name: str, class_names=None) -> SimpleNamespace:
    """The task_dict returned alongside loaders (geobenchdataset.py:365-373)."""
    return SimpleNamespace(
        class_names=(class_names if TASK_CLASS[dataset_name] != "multi_label_classification"
                     else None),
        num_classes=NUM_CLASSES[dataset_name],
        type=GEOBENCH_TASK[dataset_name],
        dataset=dataset_name,
        label_type=TASK_CLASS[dataset_name],
    )


class GeobenchSource:
    """Map-style reader over the geobench package, producing already
    normalized HWC float arrays + labels + per-band stats, the item layout
    the reference writes into beton files (geobenchdataset.py:130-166)."""

    def __init__(self, dataset_name, split="train", partition="default",
                 version="1.0", geobench_bands_type="full"):
        import geobench  # only needed offline

        if split == "val":
            split = "valid"
        benchmark = GEOBENCH_TASK[dataset_name] + f"_v{version}/"
        task = None
        for t in geobench.task_iterator(benchmark_name=benchmark):
            if t.dataset_name == dataset_name:
                task = t
        if task is None:
            raise ValueError(f"{dataset_name} not in {benchmark}")
        band_names = get_band_names(version, geobench_bands_type)[dataset_name]
        self.dataset = task.get_dataset(split=split, band_names=band_names,
                                        partition_name=partition)
        self.dataset_name = dataset_name
        self.num_classes = task.label_type.n_classes
        self.class_names = getattr(task.label_type, "class_names", None)
        sample_bands = self.dataset[0].bands
        names = [sample_bands[i].band_info.name for i in range(len(sample_bands))]
        self.band_indices = [names.index(b) for b in band_names]
        mean, std = self.dataset.normalization_stats()
        mean, std = np.asarray(mean), np.asarray(std)
        if dataset_name == "m-so2sat":
            # so2sat stats are stored x10000 vs its 0..1 data (geobenchdataset.py:143-147)
            mean, std = mean / 10000, std / 10000
        self.mean = mean.astype(np.float32)
        self.std = std.astype(np.float32)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        sample = self.dataset[idx]
        x = np.stack([sample.bands[i].data for i in self.band_indices], axis=0).astype(np.float64)
        x = (x - self.mean[:, None, None]) / self.std[:, None, None]
        x = np.ascontiguousarray(x.transpose(1, 2, 0).astype(np.float32))  # HWC

        label = sample.label
        if not isinstance(label, (int, list)):
            label = np.array(list(label.data), dtype=np.int64)
        elif isinstance(label, list):
            label = np.array(label, dtype=np.int64)
        else:
            label = np.int64(label)
        if isinstance(label, np.ndarray) and label.ndim == 3:  # seg mask CHW -> HW
            label = label[0] if label.shape[0] == 1 else label
        return {"input": x, "label": np.asarray(label), "mean": self.mean, "std": self.std,
                "id": str(idx)}


class _Items:
    """In-memory items in :class:`GeobenchSource`'s layout."""

    def __init__(self, x, label, mean, std):
        self.x, self.label, self.mean, self.std = x, label, mean, std

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return {"input": self.x[i], "label": self.label[i], "mean": self.mean, "std": self.std,
                "id": str(i)}


def generate_synthetic_geobench(out_dir: Path | str, dataset_name: str,
                                n_per_split=(16, 8, 8), seed=0, n_channels=12,
                                size: int | None = None) -> dict:
    """Synthetic packed GEO-Bench splits (no download): the same arrays, in
    the same numpy draw order, as the JAX package's generator, whose tiles
    are ``min(IMG_SIZE, 64)`` px; ``size`` sets another side (the
    segmentation recipe's 112 px)."""
    out_dir = Path(out_dir)
    rng = np.random.default_rng(seed)
    ncls = NUM_CLASSES[dataset_name]
    size = size or min(IMG_SIZE[dataset_name], 64)
    paths = {}
    for split, n in zip(("train", "val", "test"), n_per_split):
        x = rng.normal(size=(n, size, size, n_channels)).astype(np.float32)
        if TASK_CLASS[dataset_name] == "multi_label_classification":
            label = (rng.random((n, ncls)) < 0.2).astype(np.int64)
        elif TASK_CLASS[dataset_name] == "segmentation":
            label = rng.integers(0, ncls, size=(n, size, size)).astype(np.int64)
        else:
            label = rng.integers(0, ncls, size=(n,)).astype(np.int64)
        mean = np.zeros((12,), np.float32)
        std = np.ones((12,), np.float32)
        dest = out_dir / f"{split}_{dataset_name}_default"
        pack_split(_Items(x, label, mean, std), dest, log_every=0)
        paths[split] = dest
    return paths


def get_geobench_dataloaders(
    dataset_name: str,
    processed_dir: Path | str,
    batch_size: int = 32,
    splits: Sequence[str] = ("train", "val", "test"),
    partition: str = "default",
    indices: Sequence[Sequence[int]] | None = None,
    geobench_bands_type: str = "full",
    seed: int = 0,
    num_workers: int = 0,
    shard: tuple[int, int] = (0, 1),
):
    """Pack (once) and load; returns (loaders, task_dict)
    (reference geobenchdataset.py:169-374).  Train shuffles and drops the
    last partial batch; val and test keep every sample in order.
    ``num_workers``: the most threads of the native row gather.
    ``shard=(rank, world)``: each loader serves the rank's share of its
    split (JAX ``finetune.py:192-202``)."""
    processed_dir = Path(processed_dir)
    processed_dir.mkdir(parents=True, exist_ok=True)
    bands_suffix = "" if geobench_bands_type == "full" else f"_{geobench_bands_type}"
    loaders = []
    class_names = None
    for i, split in enumerate(splits):
        subset = "" if indices is None else "_subset"
        dest = processed_dir / f"{split}_{dataset_name}_{partition}{subset}{bands_suffix}"
        if not (dest / "meta.json").exists():
            src = GeobenchSource(dataset_name, split, partition, "1.0", geobench_bands_type)
            class_names = src.class_names
            if len(src) == 0:
                if split == "train":
                    raise ValueError("training dataset has no samples")
                loaders.append(None)
                continue
            print(f"packing geobench {dataset_name} {split} -> {dest}")
            pack_split(src, dest, indices=None if indices is None else indices[i])
        is_train = split == "train"
        loaders.append(PackedLoader(PackedDataset(dest), batch_size, shuffle=is_train,
                                    drop_last=is_train, seed=seed, num_workers=num_workers,
                                    shard=shard))
    return loaders, make_task_dict(dataset_name, class_names)

"""Training loader over the mmpack format (port of ``mmearth_tpu/data/loader.py``,
with the numpy row gather; the native C++ gather core is not ported yet).

Replaces ffcv.Loader (reference mmearth_dataset.py:300-316): shuffled epochs,
drop_last, and background prefetch so host gather overlaps device compute.  Rows are gathered from memory-mapped files — no per-sample
Python transform runs at training time (all transforms were applied offline by
the packer; see :mod:`mmearth_tpu_torch.data.synthetic` for the layout).
"""
from __future__ import annotations

import json
import queue
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

PREFETCH = 2  # batches gathered ahead of the consumer


class PackedDataset:
    def __init__(self, path: Path | str):
        self.path = Path(path)
        meta = json.loads((self.path / "meta.json").read_text())
        self.count: int = meta["count"]
        self.fields: dict = meta["fields"]
        self.arrays = {
            name: np.lib.format.open_memmap(self.path / f"{name}.bin", mode="r")
            for name in self.fields
        }

    def __len__(self):
        return self.count

    def gather(self, rows: np.ndarray) -> dict[str, np.ndarray]:
        return {name: np.take(arr, rows, axis=0) for name, arr in self.arrays.items()}


class PackedLoader:
    """Iterable over batches of numpy dicts.

    Parameters mirror the reference loader: ``order`` is the FFCV OrderOption
    (reference mmearth_dataset.py:306-310) — ``random`` a full permutation,
    ``quasi_random`` a locality-aware shuffle (chunks of ``chunk_size``
    consecutive rows are shuffled within windows of ``window_chunks`` chunks,
    bounding how far reads stray from sequential once the pack exceeds the
    page cache), ``sequential`` no shuffle.  ``shuffle`` is the boolean
    shorthand (True == random).  ``drop_last`` for training.
    """

    def __init__(
        self,
        dataset: PackedDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        indices: Sequence[int] | None = None,
        order: str | None = None,
        chunk_size: int = 128,
        window_chunks: int = 16,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        if order is None:
            order = "random" if shuffle else "sequential"
        if order not in ("random", "quasi_random", "sequential"):
            raise ValueError(f"unknown order {order!r}")
        self.order = order
        shuffle = order != "sequential"
        self.chunk_size = chunk_size
        self.window_chunks = window_chunks
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.base_indices = (
            np.arange(getattr(dataset, "count", len(dataset)))
            if indices is None else np.asarray(indices)
        )
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """Reshuffle per epoch (DistributedSampler.set_epoch parity,
        main_pretrain.py:337-338)."""
        self.epoch = epoch

    def _quasi_random_permutation(self, idx: np.ndarray, rng) -> np.ndarray:
        """Locality-aware shuffle: split ``idx`` (in storage order) into
        contiguous windows of chunk_size*window_chunks rows, shuffle the
        window order, and shuffle samples within each window.  Every sample
        appears exactly once and any run of window-sized reads touches one
        contiguous storage span — sequential-ish IO once the pack exceeds the
        page cache, unlike a full permutation."""
        ws = max(self.chunk_size, 1) * max(self.window_chunks, 1)
        n_windows = -(-len(idx) // ws)
        out = [rng.permutation(idx[w * ws : (w + 1) * ws]) for w in rng.permutation(n_windows)]
        return np.concatenate(out)

    def _epoch_batches(self) -> list[np.ndarray]:
        idx = self.base_indices
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            if self.order == "quasi_random":
                idx = self._quasi_random_permutation(idx, rng)
            else:
                idx = rng.permutation(idx)
        n_batches = len(idx) // self.batch_size
        batches = [
            idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(n_batches)
        ]
        if not self.drop_last and n_batches * self.batch_size < len(idx):
            batches.append(idx[n_batches * self.batch_size :])
        return batches

    def __len__(self):
        return len(self._epoch_batches())

    def _gather_batch(self, rows: np.ndarray) -> dict[str, np.ndarray]:
        # sorted gather = sequential-ish reads from the memmap
        return self.dataset.gather(np.sort(rows))

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        batches = self._epoch_batches()
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put that gives up once the consumer is gone, so an
            # abandoned iterator cannot leak a thread blocked on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for rows in batches:
                    if stop.is_set():
                        return
                    if not put(self._gather_batch(rows)):
                        return
                put(None)
            except BaseException as e:  # propagate IO/decode errors instead
                put(e)                  # of deadlocking the consumer

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

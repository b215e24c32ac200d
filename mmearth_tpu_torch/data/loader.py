"""Training loader over the mmpack format (port of ``mmearth_tpu/data/loader.py``).

Replaces ffcv.Loader (reference mmearth_dataset.py:300-316): shuffled epochs,
drop_last, per-host sharding, and background prefetch so host gather overlaps
device compute.  Rows are gathered from memory-mapped files by the native
core (:mod:`.native`, up to ``num_workers`` threads), with a readahead hint
for the next batch where the pack may not fit in the page cache — no
per-sample Python transform runs at training time (all transforms were
applied offline by the packer, :mod:`.pack`).
"""
from __future__ import annotations

import itertools
import json
import os
import queue
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from ..utils import profiling
from . import native


# the share of the host's memory past which a pack may not stay in the page
# cache, so the loader hints the OS to read the next batch's rows ahead
READAHEAD_SHARE = 0.5


def host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


class PackedDataset:
    """A packed split's fields, memory-mapped.  ``readahead``: whether the
    loader hints the OS to page in the next batch's rows — where the pack
    exceeds ``READAHEAD_SHARE`` of the host's memory.  A resident pack gains
    nothing from the hint and pays for it: a ``madvise`` a row a field,
    7.0-7.6 ms a batch of 256 on the H100 machine's host
    (``scripts/torch_gather_bench.py``)."""

    def __init__(self, path: Path | str):
        self.path = Path(path)
        meta = json.loads((self.path / "meta.json").read_text())
        self.count: int = meta["count"]
        self.fields: dict = meta["fields"]
        self.arrays = {
            name: np.lib.format.open_memmap(self.path / f"{name}.bin", mode="r")
            for name in self.fields
        }
        nbytes = sum(a.nbytes for a in self.arrays.values())
        self.readahead = nbytes > READAHEAD_SHARE * host_memory_bytes()

    def __len__(self):
        return self.count

    def gather(self, rows: np.ndarray, pin: bool = False, n_threads: int = 0) -> dict:
        """The ``rows`` of every field through the native core (at most
        ``n_threads`` threads, :func:`.native.threads_for`): numpy arrays, or with ``pin`` torch
        tensors in pinned host memory, gathered straight into their buffers
        (one copy).  A row out of range raises ``IndexError``."""
        if not pin:
            return {name: native.gather_rows(arr, rows, n_threads=n_threads)
                    for name, arr in self.arrays.items()}
        out = {}
        for name, arr in self.arrays.items():
            t = pinned_empty((len(rows), *arr.shape[1:]), arr.dtype)
            native.gather_rows(arr, rows, out=t.numpy(), n_threads=n_threads)
            out[name] = t
        return out

    def prefetch(self, rows: np.ndarray) -> None:
        """Hint the OS to page in an upcoming batch's rows."""
        for arr in self.arrays.values():
            native.prefetch_rows(arr, rows)


def pinned_empty(shape, dtype):
    """An uninitialised torch tensor of numpy ``dtype`` in pinned memory."""
    import torch

    return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype, pin_memory=True)


def pin_batch(batch: dict) -> dict:
    """A numpy batch copied into pinned torch tensors."""
    out = {}
    for k, v in batch.items():
        t = pinned_empty(v.shape, v.dtype)
        t.numpy()[...] = v
        out[k] = t
    return out


class PackedLoader:
    """Iterable over batches of numpy dicts.

    Parameters mirror the reference loader: ``order`` is the FFCV OrderOption
    (reference mmearth_dataset.py:306-310) — ``random`` a full permutation,
    ``quasi_random`` a locality-aware shuffle (chunks of ``chunk_size``
    consecutive rows are shuffled within windows of ``window_chunks`` chunks,
    bounding how far reads stray from sequential once the pack exceeds the
    page cache), ``sequential`` no shuffle.  ``shuffle`` is the boolean
    shorthand (True == random).  ``drop_last`` for training;
    ``shard=(index, count)`` statically splits samples across hosts (with
    ``drop_last`` each shard's batches are counted from the same number of
    samples, so the ranks of a process group step together).
    ``prefetch`` batches are gathered ahead by a worker thread (0: gathered
    on the consumer's thread), with at most ``num_workers`` threads of the
    native core (:func:`.native.threads_for`).  ``pin_memory`` (for a loader
    that feeds a card): the worker gathers each batch into pinned host
    memory and yields torch tensors, so the training thread only issues the
    copy to the device.
    """

    def __init__(
        self,
        dataset: PackedDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
        indices: Sequence[int] | None = None,
        prefetch: int = 2,
        num_workers: int = 0,
        order: str | None = None,
        chunk_size: int = 128,
        window_chunks: int = 16,
        pin_memory: bool = False,
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
        self.pin_memory = pin_memory
        self.seed = seed
        self.shard = shard
        self.base_indices = (
            np.arange(getattr(dataset, "count", len(dataset)))
            if indices is None else np.asarray(indices)
        )
        self.prefetch = prefetch
        # reference --num_workers (DataLoader forks / FFCV threads): here the
        # most threads of the native row-gather core (0: no cap of its own)
        self.num_workers = num_workers
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
        rank, world = self.shard
        if self.drop_last:
            idx = idx[:len(idx) // world * world]
        idx = idx[rank::world]
        n_batches = len(idx) // self.batch_size
        batches = [
            idx[i * self.batch_size : (i + 1) * self.batch_size] for i in range(n_batches)
        ]
        if not self.drop_last and n_batches * self.batch_size < len(idx):
            batches.append(idx[n_batches * self.batch_size :])
        return batches

    def __len__(self):
        return len(self._epoch_batches())

    # hooks a subclass overrides to serve another storage backend
    def _gather_batch(self, rows: np.ndarray) -> dict:
        # sorted gather = sequential-ish reads from the memmap
        return self.dataset.gather(np.sort(rows), pin=self.pin_memory,
                                   n_threads=self.num_workers)

    def _prefetch_hint(self, rows: np.ndarray) -> None:
        if self.dataset.readahead:
            self.dataset.prefetch(np.sort(rows))

    def _gathered(self, epoch: int, batch: int, rows: np.ndarray) -> dict:
        """Batch ``batch`` of ``epoch`` gathered, in a ``loader.gather``
        span, counted in ``loader.batches`` and ``loader.bytes``."""
        with profiling.span("loader.gather", epoch=epoch, batch=batch, rows=len(rows)) as sp:
            out = self._gather_batch(rows)
            nbytes = sum(v.nbytes for v in out.values())
            sp.note(bytes=nbytes)
        profiling.count("loader.batches")
        profiling.count("loader.bytes", nbytes)
        return out

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        batches = self._epoch_batches()
        epoch = self.epoch
        if self.prefetch <= 0:
            for bi, rows in enumerate(batches):
                yield self._gathered(epoch, bi, rows)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
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
                for bi, rows in enumerate(batches):
                    if stop.is_set():
                        return
                    if bi + 1 < len(batches):
                        self._prefetch_hint(batches[bi + 1])
                    if not put(self._gathered(epoch, bi, rows)):
                        return
                put(None)
            except BaseException as e:  # propagate IO/decode errors instead
                put(e)                  # of deadlocking the consumer

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            for bi in itertools.count():
                # the first wait holds the worker's start; the last, for the
                # end of the epoch, has batch == len(batches)
                with profiling.span("loader.wait" if bi else "loader.first_wait",
                                    epoch=epoch, batch=bi):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

"""ArrayRecord packs and their loader (the port's counterpart of
``mmearth_tpu/data/grain_pipeline.py``) — the cloud-storage alternative to
mmpack.

Record format (the JAX package's): one sample per record, an uncompressed
``.npz`` of its fields, every transform applied before packing as in
:mod:`.pack`; a pack is ``<out>/mmearth-NNNNN.array_record`` shards and a
``meta.json``.  Either package reads the other's packs.

The loader reads the shards with ``array_record`` alone and never imports
``grain``, which imports JAX.  It keeps grain's semantics
(``grain.python.IndexSampler`` + ``DataLoader`` as the JAX ``GrainLoader``
drives them): ``shard=(index, count)`` takes a contiguous range of the
records (``_ShardMapDataset``; with ``drop_last`` every shard holds
``count // shards``), each epoch covers every record of the shard exactly
once, the shuffle of epoch ``e`` is drawn from ``seed + e``, and the stream
(:meth:`GrainLoader.iterator`) is aligned to those epochs (JAX ``_batched``).
Unshuffled, its order is JAX's record for record; shuffled, the permutation
is numpy's, not grain's.  ``get_state``/``set_state`` give the stream's
position as JSON bytes of this package's own layout.

    python -m mmearth_tpu_torch.data.grain_pipeline --data_dir <MMEarth dir> --out <dir>
"""
from __future__ import annotations

import bisect
import io
import json
from pathlib import Path
from typing import Iterator, Mapping, Sequence

import numpy as np

from .loader import pin_batch
from .pack import CHUNK

__all__ = ["pack_arrayrecord", "GrainLoader", "have_grain"]


def require_array_record():
    """``array_record``'s module, or an ImportError that names it."""
    try:
        from array_record.python import array_record_module
    except ImportError as e:
        raise ImportError("ArrayRecord packs (--loader grain) need the array_record package, "
                          "which is not installed") from e
    return array_record_module


def have_grain() -> bool:
    """Whether ArrayRecord packs can be written and read here."""
    try:
        require_array_record()
        return True
    except ImportError:
        return False


def _encode_sample(sample: Mapping[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in sample.items()})
    return buf.getvalue()


def _decode_sample(data: bytes) -> dict[str, np.ndarray]:
    with np.load(io.BytesIO(bytes(data))) as z:
        return {k: z[k] for k in z.files}


def pack_arrayrecord(dataset, out_dir: Path | str, indices: Sequence[int] | None = None,
                     shard_size: int = 4096, log_every: int = 10000) -> Path:
    """Pack an indexable sample-dict dataset (the HDF5 reader or a list) into
    ArrayRecord shards of ``shard_size`` records and a ``meta.json``.  int64
    labels are stored int32; the ``id`` field goes to ``meta.json`` in record
    order."""
    arm = require_array_record()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    idxs = list(range(len(dataset))) if indices is None else list(indices)
    n = len(idxs)
    if n == 0:
        raise ValueError("cannot pack an empty split")

    def iter_items():
        if hasattr(dataset, "get_rows"):  # batched reads
            arr = np.asarray(idxs)
            for start in range(0, n, CHUNK):
                batch = dataset.get_rows(arr[start:start + CHUNK])
                batch_ids = batch.pop("id")
                for i, sid in enumerate(batch_ids):
                    yield str(sid), {k: v[i] for k, v in batch.items()}
        else:
            for idx in idxs:
                item = dict(dataset[idx])
                yield str(item.pop("id", idx)), item

    ids, shard_paths, writer, fields = [], [], None, None
    for row, (sample_id, item) in enumerate(iter_items()):
        ids.append(sample_id)
        item = {k: (v.astype(np.int32) if getattr(v, "dtype", None) == np.int64
                    else np.asarray(v)) for k, v in item.items()}
        if fields is None:
            fields = {k: {"shape": list(v.shape), "dtype": v.dtype.name} for k, v in item.items()}
        if writer is None:
            path = out_dir / f"mmearth-{len(shard_paths):05d}.array_record"
            shard_paths.append(path.name)
            writer = arm.ArrayRecordWriter(str(path), "group_size:1")
        writer.write(_encode_sample(item))
        if (row + 1) % shard_size == 0:
            writer.close()
            writer = None
        if log_every and row and row % log_every == 0:
            print(f"packed {row}/{n}")
    if writer is not None:
        writer.close()
    meta = {"count": n, "fields": fields, "shards": shard_paths, "ids": ids}
    (out_dir / "meta.json").write_text(json.dumps(meta))
    return out_dir


def even_split(count: int, shard: tuple[int, int], drop_remainder: bool) -> tuple[int, int]:
    """The record range [start, end) of ``shard`` (grain's ``even_split``):
    ``count // shards`` records each, and without ``drop_remainder`` the
    first ``count % shards`` shards take one more."""
    index, shards = shard
    per = count // shards
    start, end = per * index, per * (index + 1)
    if not drop_remainder:
        rem = count % shards
        start, end = start + min(index, rem), end + min(index + 1, rem)
    return start, end


class GrainLoader:
    """Iterable over batches of numpy dicts (pinned torch tensors with
    ``pin_memory``) read from an ArrayRecord pack.

    Two access modes (don't mix them in one run):
      * ``for batch in loader`` — one exact epoch per pass: every shard
        record exactly once, the partial final batch iff ``drop_last`` is
        off, reshuffled by ``set_epoch`` (seed + epoch), as ``PackedLoader``.
      * ``loader.iterator()`` — a continuous stream over epochs 0, 1, ...
        (epoch ``e`` shuffled from ``seed + e``), each epoch's partial batch
        dropped under ``drop_last`` and emitted otherwise, whose position
        round-trips through ``get_state()``/``set_state()`` (mid-epoch
        resume).
    """

    def __init__(self, path: Path | str, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0, shard: tuple[int, int] = (0, 1),
                 pin_memory: bool = False):
        arm = require_array_record()
        self.path = Path(path)
        meta = json.loads((self.path / "meta.json").read_text())
        self.count: int = meta["count"]
        self.fields: dict = meta["fields"]
        self.batch_size, self.shuffle, self.drop_last = batch_size, shuffle, drop_last
        self.seed, self.shard, self.pin_memory = seed, shard, pin_memory
        self._readers = [arm.ArrayRecordReader(str(self.path / s), "readahead_buffer_size:0")
                         for s in meta["shards"]]
        self._offsets = [0]
        for r in self._readers:
            self._offsets.append(self._offsets[-1] + r.num_records())
        if self._offsets[-1] != self.count:
            raise ValueError(f"{self.path}: shards hold {self._offsets[-1]} records, "
                             f"meta.json says {self.count}")
        self.start, self.end = even_split(self.count, shard, drop_last)
        self.epoch = 0
        # stream position: the next record is _order(seed + _stream_epoch)[_pos]
        self._stream_epoch, self._pos, self._it = 0, 0, None

    def set_epoch(self, epoch: int):
        """The next ``for`` pass reads the epoch shuffled from ``seed + epoch``."""
        self.epoch = epoch

    def __len__(self):
        n = self.end - self.start
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self, seed: int) -> np.ndarray:
        keys = np.arange(self.start, self.end)
        return np.random.default_rng(seed).permutation(keys) if self.shuffle else keys

    def _read(self, keys: np.ndarray) -> list[bytes]:
        """The records ``keys`` (global indices), in that order."""
        by_shard: dict[int, list[int]] = {}
        for i, k in enumerate(keys):
            by_shard.setdefault(bisect.bisect_right(self._offsets, int(k)) - 1, []).append(i)
        out: list = [None] * len(keys)
        for s, where in by_shard.items():
            recs = self._readers[s].read([int(keys[i]) - self._offsets[s] for i in where])
            for i, rec in zip(where, recs):
                out[i] = rec
        return out

    def _batch(self, keys: np.ndarray) -> dict:
        recs = [_decode_sample(r) for r in self._read(keys)]
        batch = {k: np.stack([r[k] for r in recs]) for k in recs[0]}
        return pin_batch(batch) if self.pin_memory else batch

    def _batches_of(self, order: np.ndarray, pos: int = 0):
        """(end position, keys) of each batch of ``order`` from ``pos``."""
        while pos < len(order):
            keys = order[pos:pos + self.batch_size]
            if len(keys) < self.batch_size and self.drop_last:
                return
            pos += len(keys)
            yield pos, keys

    def __iter__(self) -> Iterator[dict]:
        for _, keys in self._batches_of(self._order(self.seed + self.epoch)):
            yield self._batch(keys)

    def iterator(self) -> Iterator[dict]:
        """The persistent stream, from the position of the last ``set_state``."""
        if self._it is None:
            self._it = self._stream()
        return self._it

    def _stream(self) -> Iterator[dict]:
        while True:
            order = self._order(self.seed + self._stream_epoch)
            for pos, keys in self._batches_of(order, self._pos):
                self._pos = pos
                yield self._batch(keys)
            self._stream_epoch, self._pos = self._stream_epoch + 1, 0

    def get_state(self) -> bytes:
        """The stream's position after the last batch it gave."""
        return json.dumps({"epoch": self._stream_epoch, "pos": self._pos,
                           "seed": self.seed, "shard": list(self.shard)}).encode("utf-8")

    def set_state(self, state: bytes) -> None:
        obj = json.loads(bytes(state).decode("utf-8"))
        if obj["seed"] != self.seed or tuple(obj["shard"]) != tuple(self.shard):
            raise ValueError(f"loader state of seed {obj['seed']} shard {obj['shard']} given "
                             f"to a loader of seed {self.seed} shard {self.shard}")
        self._stream_epoch, self._pos, self._it = int(obj["epoch"]), int(obj["pos"]), None


def main(argv=None):
    """Offline packing CLI (the ArrayRecord counterpart of :mod:`.pack`'s)."""
    import argparse

    from ..configs import modalities as M
    from .mmearth import MMEarthDataset

    ap = argparse.ArgumentParser(description="Pack MMEarth HDF5 into ArrayRecord shards")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--splits", nargs="+", default=["train"])
    ap.add_argument("--modalities", choices=["default", "rgb", "inp_only"], default="default")
    ap.add_argument("--shard_size", type=int, default=4096)
    args = ap.parse_args(argv)
    mods = M.modality_preset(args.modalities)
    for split in args.splits:
        ds = MMEarthDataset(args.data_dir, mods, split=split)
        if len(ds) == 0:
            if split == "train":
                raise ValueError("training dataset has no samples")
            print(f"split {split!r} is empty; skipping")
            continue
        dest = Path(args.out) / f"{split}_arrayrecord"
        print(f"packing split {split!r} ({len(ds)} samples) -> {dest}")
        pack_arrayrecord(ds, dest, shard_size=args.shard_size)


if __name__ == "__main__":
    main()

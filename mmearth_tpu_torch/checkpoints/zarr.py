"""zarr v2 arrays read from a key-value store (an OCDBT store, :mod:`.ocdbt`,
or a directory, :class:`DirectoryStore`) and written into a directory.

An array ``name`` is the key ``name/.zarray`` (its JSON metadata: shape,
chunk shape, dtype, compressor, fill value, order) and one key a chunk,
``name/<i>.<j>...`` (``name/0`` for a 0-d array).  A chunk holds the whole
chunk shape, in C order, also at the edges, where the array's shape cuts it;
a missing chunk is the fill value (zeros where it is null).  A TPU mesh
writes one chunk a shard, so the chunks of a sharded array make it whole.

The compressors are ``zstd`` and none; any other is refused by name.  The
dtypes are numpy's, plus ``bfloat16``, which numpy lacks: it is read as
``uint16`` and given to torch as ``torch.bfloat16``
(:func:`to_torch`).

:func:`write_array` writes what Orbax writes for an array under
``use_ocdbt=False`` (one directory an array, beside ``_METADATA``), but
uncompressed: the whole array as one chunk in C order.
"""
from __future__ import annotations

import itertools
import json
from pathlib import Path

import numpy as np
import torch

from . import zstd

BFLOAT16 = "bfloat16"


def _numpy_dtype(name: str) -> np.dtype:
    if name == BFLOAT16:
        return np.dtype("<u2")
    try:
        return np.dtype(name)
    except TypeError as e:
        raise ValueError(f"zarr dtype {name!r} is not read here") from e


class DirectoryStore:
    """The key-value store of a directory: key ``a/b`` is the file
    ``<root>/a/b`` (Orbax's per-array layout, ``use_ocdbt=False``)."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.bytes_read = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def read(self, key: bytes | str) -> bytes | None:
        key = key.decode() if isinstance(key, bytes) else key
        path = self.root / key
        if not path.is_file():
            return None
        data = path.read_bytes()
        self.bytes_read += len(data)
        return data


def read_meta(store, name: str) -> dict:
    raw = store.read(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"no zarr array {name!r} in the store")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')}, only 2 is read")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not read here")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: zarr compressor {comp.get('id')!r} is not read here "
                         "(zstd or none)")
    return meta


def read_array(store, name: str) -> tuple[np.ndarray, str]:
    """The array ``name`` as numpy (bfloat16 as its uint16 bits) and its
    zarr dtype name."""
    meta = read_meta(store, name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype_name = meta["dtype"]
    dtype = _numpy_dtype(dtype_name)
    order = meta.get("order", "C")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    out = np.empty(shape, dtype)
    if not shape:
        chunk = _chunk(store, f"{name}/0", meta, (), dtype, order)
        out[()] = chunk if chunk is not None else _fill(fill, dtype_name, dtype)
        return out, dtype_name
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"{name}: chunks {chunks} for shape {shape}")
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/" + sep.join(str(i) for i in idx)
        chunk = _chunk(store, key, meta, chunks, dtype, order)
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        if chunk is None:
            out[where] = _fill(fill, dtype_name, dtype)
        else:
            out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    return out, dtype_name


def _chunk(store, key: str, meta: dict, chunks: tuple, dtype: np.dtype, order: str):
    raw = store.read(key)
    if raw is None:
        return None
    if meta.get("compressor") is not None:
        raw = zstd.decompress(raw)
    n = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    if len(raw) != n:
        raise ValueError(f"{key}: {len(raw)} bytes for a chunk of {chunks} {dtype}")
    return np.frombuffer(bytes(raw), dtype).reshape(chunks, order=order)


def _fill(fill, dtype_name: str, dtype: np.dtype):
    if fill is None:
        return np.zeros((), dtype)
    if dtype_name == BFLOAT16:
        bits = torch.tensor(float(fill), dtype=torch.bfloat16).view(torch.int16).numpy()
        return bits.view("<u2")
    if isinstance(fill, str):  # "NaN", "Infinity", "-Infinity"
        return np.asarray(float(fill), dtype)
    return np.asarray(fill, dtype)


def to_torch(array: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A CPU tensor of ``array`` in its own dtype (bfloat16 from its bits)."""
    if dtype_name == BFLOAT16:
        return torch.from_numpy(np.ascontiguousarray(array).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(array))


def _write_dtype(array) -> tuple[np.ndarray, str]:
    """``array`` (numpy, or a torch tensor: bfloat16 as its bits) as
    little-endian numpy and its zarr dtype name (``<f4``, ``<i4``,
    ``bfloat16``, ...)."""
    if isinstance(array, torch.Tensor):
        t = array.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("<u2"), BFLOAT16
        array = t.numpy()
    array = np.asarray(array)
    array = array.astype(array.dtype.newbyteorder("<"), copy=False)
    return array, array.dtype.str


def write_array(root: str | Path, name: str, array) -> int:
    """Write ``array`` as the zarr v2 array ``<root>/<name>``: its
    ``.zarray`` (the fields and order Orbax writes, with ``"compressor":
    null``) and one chunk holding the whole array in C order (``0.0...``,
    or ``0`` for a 0-d or 1-d array).  Returns the bytes written."""
    data, dtype_name = _write_dtype(array)
    shape = list(data.shape)
    meta = {"chunks": shape, "compressor": None, "dimension_separator": ".",
            "dtype": dtype_name, "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    d = Path(root) / name
    d.mkdir(parents=True, exist_ok=True)
    text = json.dumps(meta, separators=(",", ":"))
    (d / ".zarray").write_text(text)
    raw = np.ascontiguousarray(data).tobytes()
    (d / (".".join("0" * len(shape)) or "0")).write_bytes(raw)
    return len(text) + len(raw)

"""A read-only OCDBT key-value store (tensorstore's "optionally-cooperative
distributed B+tree", the store under an Orbax checkpoint), written from the
format's specification.

A store is a directory.  ``manifest.ocdbt`` holds the config and the version
tree: the newest versions inline, the older ones behind references to
version tree nodes.  The newest version names the root of a B+tree whose
leaves map keys to values.  Nodes, and values too long to keep inline, lie
in data files (``d/<hash>``, or ``ocdbt.process_<i>/d/<hash>`` where Orbax
merged the stores of several processes) named by each node's data file
table and read by range.  Every manifest and node is framed the same way::

    magic        u32 big-endian (manifest 0x0cdb3a2a, version tree node
                 0x0cdb1234, B+tree node 0x0cdb20de)
    length       u64 little-endian, the whole frame's
    version      varint (0)
    compression  varint (0 none, 1 zstd)
    body         the rest but the last 4 bytes, compressed as stated
    crc32c       u32 little-endian, of everything before it

Inside a body, numbers are LEB128 varints unless stated, and the fields of
a node's entries are stored column by column.  Keys are prefix-compressed:
each key after the first shares a stated number of bytes with the one
before it; a child's keys omit the prefix its parent entry states all keys
of its subtree share.

:class:`Store` offers :meth:`Store.list` and :meth:`Store.read`.  A bad
magic, version, length or checksum raises :class:`FormatError`.
"""
from __future__ import annotations

import bisect
import struct
from pathlib import Path

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
VERSION_NODE_MAGIC = 0x0CDB1234
BTREE_NODE_MAGIC = 0x0CDB20DE
FORMAT_VERSION = 0
_HEADER = 4 + 8  # magic, length
_UUID = 16
_NUMBERED = 1  # manifest_kind of a store whose versions are in numbered manifests


class FormatError(ValueError):
    """A file that is not a well-formed OCDBT frame or body."""


def _crc32c_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(0x82F63B78), table >> 1)
    return table.astype(np.uint32)


_CRC_TABLE = [int(x) for x in _crc32c_table()]


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    table, c = _CRC_TABLE, 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def unframe(data: bytes, magic: int, what: str) -> bytes:
    """The body of one frame (see the module's docstring), checked."""
    if len(data) < _HEADER + 2 + 4:
        raise FormatError(f"{what}: {len(data)} bytes is too short for a frame")
    (got,) = struct.unpack_from(">I", data, 0)
    if got != magic:
        raise FormatError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    (length,) = struct.unpack_from("<Q", data, 4)
    if length != len(data):
        raise FormatError(f"{what}: the frame states {length} bytes, {len(data)} were read")
    (crc,) = struct.unpack_from("<I", data, len(data) - 4)
    if crc32c(data[:-4]) != crc:
        raise FormatError(f"{what}: checksum mismatch")
    r = _Reader(data, _HEADER, len(data) - 4, what)
    version = r.varint()
    if version != FORMAT_VERSION:
        raise FormatError(f"{what}: format version {version}, this reader knows "
                          f"{FORMAT_VERSION}")
    compression = r.varint()
    rest = data[r.pos:len(data) - 4]
    if compression == 0:
        return bytes(rest)
    if compression == 1:
        return bytes(zstd.decompress(rest))
    raise FormatError(f"{what}: compression format {compression} is not known")


class _Reader:
    """Sequential reads from ``data[pos:end]``."""

    def __init__(self, data: bytes, pos: int = 0, end: int | None = None, what: str = ""):
        self.data, self.pos = data, pos
        self.end = len(data) if end is None else end
        self.what = what

    def _need(self, n: int) -> None:
        if self.pos + n > self.end:
            raise FormatError(f"{self.what}: truncated")

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            self._need(1)
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise FormatError(f"{self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def u8s(self, n: int) -> list[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> list[int]:
        return list(struct.unpack("<%dQ" % n, self.take(8 * n)))

    def take(self, n: int) -> bytes:
        self._need(n)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def done(self) -> None:
        if self.pos != self.end:
            raise FormatError(f"{self.what}: {self.end - self.pos} bytes left over")


def _prefixed_strings(r: _Reader, n: int, interior: bool = False):
    """``n`` prefix-compressed keys: the shared lengths of entries 1 to n-1,
    the suffix lengths of all n, in an interior node each subtree's common
    prefix length, then the suffixes.  Returns (keys, common prefix
    lengths or None)."""
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    out, prev = [], b""
    for s, m in zip(shared, suffix):
        if s > len(prev):
            raise FormatError(f"{r.what}: a key shares {s} bytes with one of {len(prev)}")
        prev = prev[:s] + r.take(m)
        out.append(prev)
    return out, common


def _data_file_table(r: _Reader) -> list[str]:
    """The node's data files as paths relative to the store: each a base
    path then a relative path (their joint string is prefix-compressed)."""
    n = r.varint()
    if not n:
        return []
    shared = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    base = r.varints(n)
    out, prev = [], b""
    for s, m, b in zip(shared, suffix, base):
        prev = prev[:s] + r.take(m)
        if b > len(prev):
            raise FormatError(f"{r.what}: a base path of {b} bytes in a path of {len(prev)}")
        out.append(prev.decode())
    return out


class _Location:
    __slots__ = ("file", "offset", "length")

    def __init__(self, file: str, offset: int, length: int):
        self.file, self.offset, self.length = file, offset, length


def _locations(r: _Reader, files: list[str], n: int, lengths: list[int] | None = None):
    ids = r.varints(n)
    offsets = r.varints(n)
    lengths = r.varints(n) if lengths is None else lengths
    for i in ids:
        if i >= len(files):
            raise FormatError(f"{r.what}: data file {i} of a table of {len(files)}")
    return [_Location(files[i], o, m) for i, o, m in zip(ids, offsets, lengths)]


class Store:
    """The newest version of the OCDBT store in directory ``root``."""

    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.bytes_read = 0
        self._files: dict[str, object] = {}
        path = self.root / "manifest.ocdbt"
        if not path.is_file():
            raise FileNotFoundError(f"{self.root}: no manifest.ocdbt (not an OCDBT store)")
        body = unframe(path.read_bytes(), MANIFEST_MAGIC, str(path))
        r = _Reader(body, what=str(path))
        self.config = self._config(r)
        if self.config["manifest_kind"] == _NUMBERED:
            raise FormatError(f"{path}: a store of numbered manifests is not read here "
                              "(Orbax writes single-manifest stores)")
        files = _data_file_table(r)
        versions = self._versions(r, files)
        refs = self._version_refs(r, files, with_height=True)
        r.done()
        self.root_ref = self._newest(versions, refs)
        self._keys: list[bytes] | None = None
        self._values: list | None = None

    # -- manifest and version tree ---------------------------------------
    @staticmethod
    def _config(r: _Reader) -> dict:
        uuid = r.take(_UUID)
        cfg = {"uuid": uuid.hex(), "manifest_kind": r.varint(),
               "max_inline_value_bytes": r.varint(), "max_decoded_node_bytes": r.varint(),
               "version_tree_arity_log2": r.u8s(1)[0]}
        method = r.varint()
        if method == 0:
            cfg["compression"] = None
        elif method == 1:
            (level,) = struct.unpack("<i", r.take(4))
            cfg["compression"] = {"id": "zstd", "level": level}
        else:
            raise FormatError(f"{r.what}: compression method {method} is not known")
        return cfg

    @staticmethod
    def _versions(r: _Reader, files: list[str]) -> list[dict]:
        """A leaf of the version tree: each version's generation and root."""
        n = r.varint()
        gens = r.varints(n)
        heights = r.u8s(n)
        locs = _locations(r, files, n)
        num_keys = r.varints(n)
        r.varints(n)  # num_tree_bytes
        r.varints(n)  # num_indirect_value_bytes
        r.u64s(n)  # commit_time
        return [{"generation": g, "height": h, "location": loc, "num_keys": k}
                for g, h, loc, k in zip(gens, heights, locs, num_keys)]

    @staticmethod
    def _version_refs(r: _Reader, files: list[str], with_height: bool,
                      height: int = 0) -> list[dict]:
        """References to version tree nodes (the manifest's carry each
        node's height; an interior node's children are one below it)."""
        n = r.varint()
        gens = r.varints(n)
        locs = _locations(r, files, n)
        r.varints(n)  # num_generations
        r.u64s(n)  # commit_time
        heights = r.u8s(n) if with_height else [height - 1] * n
        return [{"generation": g, "location": loc, "height": h}
                for g, loc, h in zip(gens, locs, heights)]

    def _newest(self, versions: list[dict], refs: list[dict]) -> dict | None:
        """The version of the highest generation, descending the version
        tree where the manifest holds it behind references only."""
        while True:
            if versions:
                return max(versions, key=lambda v: v["generation"])
            if not refs:
                return None
            ref = max(refs, key=lambda v: v["generation"])
            what = f"version tree node {ref['location'].file}@{ref['location'].offset}"
            body = unframe(self._range(ref["location"]), VERSION_NODE_MAGIC, what)
            r = _Reader(body, what=what)
            arity, height = r.u8s(2)
            if arity != self.config["version_tree_arity_log2"] or height != ref["height"]:
                raise FormatError(f"{what}: arity {arity} at height {height}, expected "
                                  f"{self.config['version_tree_arity_log2']} at {ref['height']}")
            files = _data_file_table(r)
            if height == 0:
                versions, refs = self._versions(r, files), []
            else:
                versions, refs = [], self._version_refs(r, files, False, height)
            r.done()

    # -- data files -------------------------------------------------------
    def _range(self, loc: _Location) -> bytes:
        """``loc.length`` bytes at ``loc.offset`` of its data file, read by
        range from a handle kept open."""
        f = self._files.get(loc.file)
        if f is None:
            path = self.root / loc.file
            if not path.is_file():
                raise FileNotFoundError(f"{self.root}: data file {loc.file} is missing")
            f = self._files[loc.file] = open(path, "rb")  # noqa: SIM115 (closed by close())
        f.seek(loc.offset)
        data = f.read(loc.length)
        if len(data) != loc.length:
            raise FormatError(f"{loc.file}: {loc.length} bytes at {loc.offset} run past its end")
        self.bytes_read += loc.length
        return data

    def close(self) -> None:
        for f in self._files.values():
            f.close()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the B+tree -------------------------------------------------------
    def _walk(self) -> None:
        """Every key and its value (bytes inline, or a location) of the
        newest version, in key order."""
        keys, values = [], []
        if self.root_ref is not None and self.root_ref["num_keys"]:
            self._node(self.root_ref["location"], self.root_ref["height"], b"", keys, values)
        if any(a >= b for a, b in zip(keys, keys[1:])):
            raise FormatError(f"{self.root}: keys out of order")
        self._keys, self._values = keys, values

    def _node(self, loc: _Location, height: int, prefix: bytes, keys: list, values: list):
        what = f"B+tree node {loc.file}@{loc.offset}"
        body = unframe(self._range(loc), BTREE_NODE_MAGIC, what)
        r = _Reader(body, what=what)
        (got,) = r.u8s(1)
        if got != height:
            raise FormatError(f"{what}: height {got}, its parent says {height}")
        files = _data_file_table(r)
        n = r.varint()
        node_keys, common = _prefixed_strings(r, n, interior=height > 0)
        if height == 0:
            lengths = r.varints(n)
            kinds = r.u8s(n)
            if any(k > 1 for k in kinds):
                raise FormatError(f"{what}: value kind {max(kinds)} is not known")
            indirect = [i for i, k in enumerate(kinds) if k == 1]
            locs = _locations(r, files, len(indirect), [lengths[i] for i in indirect])
            where = dict(zip(indirect, locs))
            for i, key in enumerate(node_keys):
                keys.append(prefix + key)
                values.append(where[i] if i in where else r.take(lengths[i]))
            r.done()
            return
        locs = _locations(r, files, n)
        r.varints(n)  # num_keys
        r.varints(n)  # num_tree_bytes
        r.varints(n)  # num_indirect_value_bytes
        r.done()
        for key, c, child in zip(node_keys, common, locs):
            if c > len(key):
                raise FormatError(f"{what}: a subtree prefix of {c} bytes on a key of {len(key)}")
            self._node(child, height - 1, prefix + key[:c], keys, values)

    def list(self) -> list[bytes]:
        """Every key of the newest version, sorted."""
        if self._keys is None:
            self._walk()
        return list(self._keys)

    def read(self, key: bytes | str) -> bytes | None:
        """The value of ``key``, or None where the store has no such key."""
        if self._keys is None:
            self._walk()
        key = key.encode() if isinstance(key, str) else bytes(key)
        i = bisect.bisect_left(self._keys, key)
        if i == len(self._keys) or self._keys[i] != key:
            return None
        value = self._values[i]
        return value if isinstance(value, bytes) else self._range(value)


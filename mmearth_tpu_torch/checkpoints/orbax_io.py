"""The JAX package's Orbax checkpoints, read and written (port of
``mmearth_tpu/checkpoints/orbax_io.py``), with no orbax or tensorstore.

The JAX package writes two kinds of directory:

* a run's checkpoints, ``<output_dir>/checkpoints/<epoch>/`` (Orbax's
  ``CheckpointManager``), each finished one holding ``_CHECKPOINT_METADATA``
  and its payload in ``default/``: ``{"params", "opt_state", "step"}`` plus
  ``"model_state"`` (the ResNets' ``batch_stats``) and ``"ema_params"``
  where the run has them; beside them ``loader-<epoch>.bin`` (process 0's
  grain position) and ``loader-<epoch>-p<i>.bin`` (process i's);
* a params directory (``save_params``: the finetune's ``checkpoint-best``).

A payload directory holds ``_METADATA`` (JSON: each leaf's key path, with
``key_type`` 2 for a dict key or a named tuple's field and 1 for a sequence
index, and its value type) and zarr v2 arrays (:mod:`.zarr`), one a leaf,
named by the key path joined with dots: in an OCDBT store (:mod:`.ocdbt`),
Orbax's default, or one directory an array (``"use_ocdbt": false``).

Leaves come back as numpy arrays, except bfloat16 ones, which numpy lacks:
those are ``torch.bfloat16`` tensors (:func:`numpy_tree` makes them f32).

The port writes both kinds too (:func:`save`, :func:`save_params`), in the
per-array layout, uncompressed, which JAX's ``CheckpointIO.restore``,
``restore_explicit``, ``load_params`` and ``load_pretrained`` read: the
params, the optax state of the run's ``--opt`` chain
(``convert.to_jax_opt_state``), ``step``, the ResNets' ``batch_stats`` and
the EMA, with each rank's grain position (:func:`grain_state`) beside the
step.  The drivers write ``.pth`` (``pth_io.py``), of which the JAX package
takes the params alone; ``scripts/torch_to_orbax.py`` turns a port run's
``.pth`` into these directories.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from . import zarr
from .ocdbt import Store

METADATA = "_METADATA"
STEP_METADATA = "_CHECKPOINT_METADATA"
_DICT_KEY, _SEQUENCE_INDEX = 2, 1
_ARRAY_TYPES = ("jax.Array", "np.ndarray", "scalar")
# empty nodes: None (optax's empty states) and empty containers
_EMPTY = {"None": lambda: None, "Tuple": list, "List": list, "Dict": dict}


class ReadStats:
    """What the reads of this process took: bytes read from the stores'
    files, bytes of the arrays decoded from them, and host seconds spent in
    :func:`load_tree`."""

    bytes_read = 0
    array_bytes = 0
    seconds = 0.0

    @classmethod
    def reset(cls) -> None:
        cls.bytes_read, cls.array_bytes, cls.seconds = 0, 0, 0.0


def payload_dir(path: str | Path) -> Path:
    """The directory holding ``_METADATA``: ``path`` itself (a params
    directory, or a step's ``default/``) or a step directory's ``default/``."""
    p = Path(path)
    if (p / METADATA).is_file():
        return p
    if (p / "default" / METADATA).is_file():
        return p / "default"
    raise FileNotFoundError(f"{p}: no Orbax {METADATA} in it or in its default/")


def load_tree(path: str | Path) -> Any:
    """The nested tree that a payload's ``_METADATA`` describes: dicts for
    key type 2, lists for key type 1, None where the tree held None (optax's
    empty states), an empty list or dict for an empty container, and each
    array leaf read from the store."""
    t0 = time.perf_counter()
    root = payload_dir(path)
    meta = json.loads((root / METADATA).read_text())
    entries = meta["tree_metadata"]
    tree: Any = None
    store_type = Store if meta.get("use_ocdbt", True) else zarr.DirectoryStore
    with store_type(root) as store:
        for entry in entries.values():
            keys = entry["key_metadata"]
            value = entry["value_metadata"]
            kind = value.get("value_type")
            if kind in _ARRAY_TYPES:
                name = ".".join(str(k["key"]) for k in keys)
                array, dtype_name = zarr.read_array(store, name)
                ReadStats.array_bytes += array.nbytes
                leaf = (zarr.to_torch(array, dtype_name) if dtype_name == zarr.BFLOAT16
                        else array)
                if kind == "scalar":
                    leaf = array.item()
            elif kind in _EMPTY:
                leaf = _EMPTY[kind]()
            else:
                raise ValueError(f"{root}: leaf {[k['key'] for k in keys]} of type {kind!r} "
                                 "is not read here")
            tree = _insert(tree, keys, leaf)
        ReadStats.bytes_read += store.bytes_read
    ReadStats.seconds += time.perf_counter() - t0
    return _lists(tree)


def _insert(node, keys: list[dict], leaf):
    if not keys:
        return leaf
    key, kind = keys[0]["key"], keys[0]["key_type"]
    if node is None:
        node = {}
    if kind == _SEQUENCE_INDEX:
        key = int(key)
        node.setdefault("__list__", True)
    elif kind != _DICT_KEY:
        raise ValueError(f"key type {kind} is not known")
    node[key] = _insert(node.get(key), keys[1:], leaf)
    return node


def _lists(node):
    if not isinstance(node, dict):
        return node
    if node.pop("__list__", False):
        n = max(node) + 1 if node else 0
        return [_lists(node.get(i)) for i in range(n)]
    return {k: _lists(v) for k, v in node.items()}


def numpy_tree(tree):
    """``tree`` with every leaf a numpy array (bfloat16 tensors as f32)."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [numpy_tree(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def load_params(path: str | Path):
    """A ``save_params`` directory (e.g. the finetune's ``checkpoint-best``)
    or a step's payload: its tree."""
    return load_tree(path)


def _resolve_ckpt_root(p: Path) -> tuple[Path, int | None]:
    """An explicit ``--resume`` path -> (the ``checkpoints`` root, the
    pinned epoch or None): a run's output directory (holding
    ``checkpoints/``), a ``checkpoints`` root, or an epoch's directory
    ``checkpoints/<N>`` (JAX ``orbax_io.py:127-148``)."""
    if p.name.isdigit() and (p / "default").exists():
        return p.parent, int(p.name)
    if (p / "checkpoints").is_dir():
        return p / "checkpoints", None
    return p, None


def latest_epoch(root: str | Path) -> int | None:
    """The newest epoch of the finished step directories under ``root``
    (numeric names holding ``_CHECKPOINT_METADATA``; Orbax's
    ``*.orbax-checkpoint-tmp-*`` directories are not), or None."""
    return max(_steps(Path(root)), default=None)


def _steps(root: Path) -> list[int]:
    """The epochs of the finished step directories under ``root``, oldest first."""
    return sorted(int(p.name) for p in root.iterdir()
                  if p.name.isdigit() and (p / STEP_METADATA).is_file()) if root.is_dir() else []


def _loader_file(epoch: int, rank: int) -> str:
    return f"loader-{epoch}.bin" if rank == 0 else f"loader-{epoch}-p{rank}.bin"


def find_loader_state(path: str | Path, epoch: int, rank: int = 0) -> bytes | None:
    """Process ``rank``'s ``loader-<epoch>[-p<rank>].bin`` beside the
    checkpoint at ``path`` (resolved as ``--resume`` is)."""
    root, _ = _resolve_ckpt_root(Path(path).absolute())
    f = root / _loader_file(epoch, rank)
    return f.read_bytes() if f.exists() else None


def loader_position(state: bytes, epoch: int, loader) -> bytes:
    """The port's stream position (``data/grain_pipeline.py::GrainLoader``)
    for JAX's grain position ``state`` saved at the end of ``epoch``.

    JAX's driver saves at an epoch's end, after ``len(loader)`` full
    batches of the epoch's shuffle, so its position maps to the start of
    the port's next epoch.  Any other position is refused: the port's
    shuffled order is numpy's, not grain's, so a position inside an epoch
    would name other records."""
    obj = json.loads(bytes(state).decode("utf-8"))
    if not isinstance(obj, dict) or "mmearth_pos" not in obj:
        raise ValueError(f"the grain position of epoch {epoch} is not the JAX GrainLoader's "
                         "(no mmearth_pos)")
    shard = re.search(r"shard_index=(\d+), shard_count=(\d+)", str(obj.get("grain", "")))
    if shard and (int(shard[1]), int(shard[2])) != tuple(loader.shard):
        raise ValueError(f"the grain position of epoch {epoch} is shard {shard[1]} of "
                         f"{shard[2]}; this loader reads shard {loader.shard[0]} of "
                         f"{loader.shard[1]}")
    pos = int(obj["mmearth_pos"])
    full = len(loader) * loader.batch_size
    if pos != full:
        raise ValueError(
            f"the grain position of epoch {epoch} is {pos} records into its epoch, not at its "
            f"end ({full}): only an epoch boundary maps to the port's stream, whose shuffled "
            "order is numpy's, not grain's")
    return json.dumps({"epoch": epoch + 1, "pos": 0, "seed": loader.seed,
                       "shard": list(loader.shard)}).encode("utf-8")


def is_step(path: str | Path) -> bool:
    """Whether ``path`` is a finished ``CheckpointManager`` step directory."""
    p = Path(path)
    return p.is_dir() and (p / STEP_METADATA).is_file() and (p / "default").is_dir()


def port_state(tree, model: torch.nn.Module, use_ema: bool = False) -> dict[str, torch.Tensor]:
    """The port's state dict of ``model`` from a loaded step (its
    ``params``, or its ``ema_params`` with ``use_ema``; the ResNets'
    BatchNorm statistics from its ``model_state``)."""
    from .convert import params_converter
    from .pth_io import model_state

    params = numpy_tree(tree["ema_params" if use_ema else "params"])
    return model_state(params_converter(model, _batch_stats(tree))(params), model)


def _batch_stats(tree):
    state = tree.get("model_state")
    return numpy_tree(state.get("batch_stats")) if isinstance(state, dict) else None


def restore(path: str | Path, model: torch.nn.Module, optimizer=None,
            ema: dict[str, torch.Tensor] | None = None, mesh=None) -> int:
    """Load the step directory ``path`` (``checkpoints/<epoch>``) into
    ``model`` (strictly), and into ``optimizer`` and ``ema`` where given
    (the optax state through ``convert.from_jax_opt_state``, the EMA from
    ``ema_params`` where the step holds it); returns its epoch.  On a grid
    (``mesh``) whose model axis splits leaves, each rank takes its slices
    (``parallel/mesh.py::place_state``), as from a ``.pth``."""
    from ..parallel import mesh as mesh_lib
    from .convert import from_jax_opt_state, params_converter

    path = Path(path)
    tree = load_tree(path)
    to_port = params_converter(model, _batch_stats(tree))
    opt_state = None
    if optimizer is not None:
        opt_state = from_jax_opt_state(numpy_tree(tree["opt_state"]), optimizer,
                                       numpy_tree(tree["params"]), to_port)
    mesh_lib.place_state(model, optimizer, mesh, port_state(tree, model), opt_state)
    if ema is not None and tree.get("ema_params") is not None:
        theirs = to_port(numpy_tree(tree["ema_params"]))
        theirs = mesh_lib.shard_state({n: theirs[n] for n in ema}, model, mesh)
        for name, t in ema.items():
            t.copy_(theirs[name])
    return int(path.name)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_TMP = ".orbax-checkpoint-tmp-"


class WriteStats:
    """What the writes of this process took: bytes written and host seconds
    spent in :func:`write_tree`."""

    bytes_written = 0
    seconds = 0.0

    @classmethod
    def reset(cls) -> None:
        cls.bytes_written, cls.seconds = 0, 0.0


def _flatten(tree, keys=()):
    """(key metadata, leaf) in JAX's flatten order: a plain dict's keys
    sorted, a :class:`convert.Fields`' in their order, a list's by index;
    None and ``()`` are leaves (optax's empty nodes, ``skip_state``)."""
    from .convert import Fields

    if isinstance(tree, dict):
        items = tree.items() if isinstance(tree, Fields) else sorted(tree.items())
        for k, v in items:
            yield from _flatten(v, (*keys, {"key": str(k), "key_type": _DICT_KEY}))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, (*keys, {"key": str(i), "key_type": _SEQUENCE_INDEX}))
    else:
        yield list(keys), tree


def write_tree(path: str | Path, tree) -> int:
    """Write ``tree`` as an Orbax payload directory at ``path``: its
    ``_METADATA`` (the key paths and value types Orbax records, the
    per-array layout) and one zarr array a leaf.  Returns the bytes written."""
    t0 = time.perf_counter()
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    entries, written = {}, 0
    for keys, leaf in _flatten(tree):
        name = tuple(k["key"] for k in keys)
        if leaf is None:
            value = {"value_type": "None", "skip_deserialize": True}
        elif isinstance(leaf, tuple) and not leaf:
            value = {"value_type": "Tuple", "skip_deserialize": True}
        else:
            written += zarr.write_array(root, ".".join(name), leaf)
            value = {"value_type": "jax.Array", "skip_deserialize": False,
                     "write_shape": list(np.shape(leaf))}
        entries[str(name)] = {"key_metadata": keys, "value_metadata": value}
    text = json.dumps({"tree_metadata": entries, "use_ocdbt": False, "use_zarr3": False,
                       "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    (root / METADATA).write_text(text)
    written += len(text)
    WriteStats.bytes_written += written
    WriteStats.seconds += time.perf_counter() - t0
    return written


def _step_metadata(handlers, custom: dict, t0: int) -> str:
    return json.dumps({"item_handlers": handlers, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": custom})


def _replace_dir(tmp: Path, final: Path) -> None:
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)


def save_params(path: str | Path, tree) -> Path:
    """A params-only directory at ``path`` (JAX's ``save_params``, the
    finetune's ``checkpoint-best``), replacing one that is there; written
    under a temporary name and renamed into place."""
    t0 = time.time_ns()
    final = Path(path).absolute()
    tmp = final.with_name(f"{final.name}{_TMP}{t0}")
    write_tree(tmp, tree)
    (tmp / STEP_METADATA).write_text(_step_metadata(HANDLER, {}, t0))
    _replace_dir(tmp, final)
    return final


def state_payload(model: torch.nn.Module, optimizer, ema: dict | None = None,
                  whole: tuple | None = None) -> dict:
    """JAX's ``_state_payload`` of the port's state: ``params``,
    ``opt_state`` and ``step``, ``model_state.batch_stats`` for a model
    with BatchNorm and ``ema_params`` with an EMA.  ``whole``: the model's
    and the optimizer's whole state dicts (``mesh.gather_state`` on a
    grid), else theirs."""
    from .convert import flax_converter, jax_step, to_jax_opt_state

    sd, opt_sd = whole if whole is not None else (model.state_dict(), optimizer.state_dict())
    to_flax = flax_converter(model)
    params, stats = to_flax(sd)
    payload = {"params": params,
               "opt_state": to_jax_opt_state(opt_sd, optimizer, model, sd),
               "step": np.asarray(jax_step(opt_sd, optimizer.update_freq), np.int32)}
    if stats is not None:
        payload["model_state"] = {"batch_stats": stats}
    if ema is not None:
        payload["ema_params"] = to_flax({**sd, **ema})[0]
    return payload


def save(output_dir: str | Path, epoch: int, model: torch.nn.Module, optimizer, args,
         ema: dict | None = None, loader_state: bytes | list[bytes] | None = None,
         keep: int = 3, whole: tuple | None = None) -> Path:
    """Write ``<output_dir>/checkpoints/<epoch>/`` as JAX's
    ``CheckpointIO.save`` does (:func:`state_payload` in ``default/``,
    ``_CHECKPOINT_METADATA`` beside it, the flags ``args`` in its
    ``custom_metadata``), under ``<epoch>.orbax-checkpoint-tmp-<n>`` and
    renamed into place, with ``loader_state`` (JAX's grain bytes,
    :func:`grain_state`; a list, one a rank) as ``loader-<epoch>.bin`` and
    ``loader-<epoch>-p<rank>.bin``; then keep the newest ``keep`` steps
    (``keep`` <= 0 keeps every one) and their loader files.  One process
    writes it: on a grid, rank 0, with ``whole`` from ``mesh.gather_state``."""
    t0 = time.time_ns()
    root = Path(output_dir).absolute() / "checkpoints"
    root.mkdir(parents=True, exist_ok=True)
    tmp = root / f"{epoch}{_TMP}{t0}"
    write_tree(tmp / "default", state_payload(model, optimizer, ema, whole))
    custom = {"args": json.loads(json.dumps(dict(args or {}), default=str))}
    (tmp / STEP_METADATA).write_text(_step_metadata({"default": HANDLER}, custom, t0))
    final = root / str(epoch)
    _replace_dir(tmp, final)
    states = loader_state if isinstance(loader_state, list) else (
        [] if loader_state is None else [loader_state])
    for rank, b in enumerate(states):
        target = root / _loader_file(epoch, rank)
        part = target.with_name(target.name + ".tmp")
        part.write_bytes(bytes(b))
        os.replace(part, target)
    if keep > 0:
        for old in _steps(root)[:-keep]:
            shutil.rmtree(root / str(old))
            for f in root.glob(f"loader-{old}*.bin"):
                if re.fullmatch(rf"loader-{old}(-p\d+)?\.bin", f.name):
                    f.unlink()
    return final


def grain_state(position: bytes, count: int, shards: list[str], data_path: str | Path,
                batch_size: int, worker_count: int = 0) -> bytes:
    """JAX's ``GrainLoader.get_state()`` bytes for the port's stream
    position ``position`` (``data/grain_pipeline.py::GrainLoader``) at an
    epoch's end, the inverse of :func:`loader_position`: ``mmearth_pos`` and
    grain's own JSON (``last_seen_indices`` and ``last_worker_index`` of the
    records consumed, ``worker_count``, the sampler's and the data source's
    reprs, which grain checks on ``set_state``).

    ``count`` and ``shards`` are the pack's ``meta.json``'s; ``data_path``
    the pack's directory as the JAX run names it (its data source hashes
    the shard paths ``str(Path(data_path) / shard)``); ``batch_size`` the
    JAX process's batch, the port rank's; ``worker_count`` the JAX loader's
    (its driver's ``0 if num_workers <= 1 else num_workers``).  The JAX
    stream reads each epoch's records from the shard's start and drops the
    tail past the epoch's full batches as it starts the next epoch, so
    after ``E`` epochs it has consumed ``(E - 1) * per_shard + full``
    records.  A position inside an epoch is refused: the port's shuffle is
    numpy's, not grain's."""
    obj = json.loads(bytes(position).decode("utf-8"))
    rank, world = (int(x) for x in obj["shard"])
    per_shard = count // world
    full = per_shard // batch_size * batch_size
    epoch, pos = int(obj["epoch"]), int(obj["pos"])
    if pos == full:
        done = epoch + 1
    elif pos == 0:
        done = epoch
    else:
        raise ValueError(
            f"the stream position is {pos} records into epoch {epoch}, not at its end "
            f"({full}): only an epoch boundary maps to the JAX package's grain stream, whose "
            "shuffled order is grain's, not numpy's")
    consumed = (done - 1) * per_shard + full if done else 0
    workers = max(worker_count, 1)
    # worker w reads the shard's records w, w + workers, ...; each last one
    # seen, as a global index of the shard's stride
    last = {str(w): rank + world * (consumed - 1 - (consumed - 1 - w) % workers)
            for w in range(workers)}
    sampler = (f"IndexSampler(num_records={count}, shard_options=ShardOptions("
               f"shard_index={rank}, shard_count={world}, drop_remainder=True), "
               f"shuffle=True, num_epochs=None, seed={int(obj['seed'])})")
    h = hashlib.sha1()
    for shard in shards:
        h.update(str(Path(data_path) / shard).encode())
    grain = {"version": 2, "last_seen_indices": last,
             "last_worker_index": (consumed - 1) % workers if worker_count > 0 and consumed
             else -1,
             "worker_count": worker_count, "sampler": sampler,
             "data_source": f"ArrayRecordDataSource(hash_of_paths={h.hexdigest()})"}
    return json.dumps({"mmearth_pos": full if done else 0,
                       "grain": json.dumps(grain, indent=4)}).encode("utf-8")

"""Reading the JAX package's Orbax checkpoints (port of the reading side of
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
index, and its value type) and an OCDBT store (:mod:`.ocdbt`) of zarr v2
arrays (:mod:`.zarr`), one a leaf, named by the key path joined with dots.

Leaves come back as numpy arrays, except bfloat16 ones, which numpy lacks:
those are ``torch.bfloat16`` tensors (:func:`numpy_tree` makes them f32).
The port writes ``.pth`` only (``pth_io.py``); the JAX package reads those.
"""
from __future__ import annotations

import json
import re
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
    with Store(root) as store:
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
    root = Path(root)
    found = [int(p.name) for p in root.iterdir()
             if p.name.isdigit() and (p / STEP_METADATA).is_file()] if root.is_dir() else []
    return max(found, default=None)


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

"""Checkpoint save and resume in upstream's ``.pth`` layout (the port's
counterpart of ``mmearth_tpu/checkpoints/orbax_io.py``; the reference's
``save_model`` / ``auto_load_model``, helpers.py:529-610).

A run's checkpoints are ``<output_dir>/checkpoint-<epoch>.pth``, each
``{"model": state_dict, "optimizer": Optimizer.state_dict(), "epoch": int,
"args": dict}`` with ``"ema"`` where the finetune keeps an EMA and
``"loader_state"`` (the stream position of ``--loader grain``, its bytes as
a uint8 tensor, or a list of them, one a rank, from a run of several
ranks) where the pretraining stream keeps one: tensors and plain
Python values only, so ``torch.load(..., weights_only=True)`` reads
them.  A run whose ``model`` axis splits leaves saves them whole
(``parallel/mesh.py::gather_state``), so its file is that of a run on one
grid row, and any grid resumes from any file (``restore``'s ``mesh``).  A
file is written to a temporary name and renamed into place, so a
run killed mid-write leaves the previous checkpoints whole; only the newest
``keep`` numbered files are kept.  Loading maps every tensor to the CPU and
copies it onto the model's device, so a file saved on the card resumes on
the CPU and the other way round.
"""
from __future__ import annotations

import os
import pickle
import re
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ..parallel import mesh as mesh_lib
from .load_pretrained import remap_minkowski_keys

_NUMBERED = re.compile(r"checkpoint-(\d+)\.pth")


def checkpoint_path(output_dir: str | Path, epoch: int | str) -> Path:
    return Path(output_dir) / f"checkpoint-{epoch}.pth"


def numbered_checkpoints(output_dir: str | Path) -> list[tuple[int, Path]]:
    """(epoch, path) of every ``checkpoint-<epoch>.pth`` in ``output_dir``,
    oldest first (``checkpoint-best.pth`` is not numbered)."""
    found = []
    for p in Path(output_dir).glob("checkpoint-*.pth"):
        m = _NUMBERED.fullmatch(p.name)
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


def latest_checkpoint(output_dir: str | Path) -> Path | None:
    """The newest checkpoint of a run's output directory: its newest
    ``checkpoint-<epoch>.pth``, or the JAX package's newest Orbax step
    ``checkpoints/<epoch>/`` (``orbax_io.py``) where that epoch is later;
    a ``.pth`` wins a tie."""
    from . import orbax_io

    found = numbered_checkpoints(output_dir)
    epoch = orbax_io.latest_epoch(Path(output_dir) / "checkpoints")
    if epoch is not None and (not found or epoch > found[-1][0]):
        return Path(output_dir) / "checkpoints" / str(epoch)
    return found[-1][1] if found else None


def write(path: str | Path, payload: Mapping) -> Path:
    """``torch.save`` to a temporary file beside ``path``, then rename."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(dict(payload), tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(output_dir: str | Path, epoch: int, model: torch.nn.Module, optimizer,
                    args: Mapping, ema: Mapping[str, torch.Tensor] | None = None,
                    keep: int = 3, loader_state: bytes | list[bytes] | None = None) -> Path:
    """Write ``checkpoint-<epoch>.pth`` and delete all but the newest
    ``keep`` numbered checkpoints (``keep`` <= 0 keeps every one).  One
    process writes it: under a process group, rank 0, with every rank's
    ``loader_state`` in rank order.  ``model`` and ``optimizer`` are the
    objects, or their whole state dicts (``mesh.gather_state`` of a
    grid)."""
    state = lambda x: x.state_dict() if hasattr(x, "state_dict") else dict(x)  # noqa: E731
    payload = {"model": state(model), "optimizer": state(optimizer),
               "epoch": epoch, "args": dict(args)}
    if ema is not None:
        payload["ema"] = dict(ema)
    if loader_state is not None:
        payload["loader_state"] = ([_bytes_tensor(b) for b in loader_state]
                                   if isinstance(loader_state, list)
                                   else _bytes_tensor(loader_state))
    path = write(checkpoint_path(output_dir, epoch), payload)
    if keep > 0:
        for _, old in numbered_checkpoints(output_dir)[:-keep]:
            old.unlink(missing_ok=True)
    return path


def _bytes_tensor(b: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(b), dtype=torch.uint8)


def load(path: str | Path) -> dict:
    """A checkpoint's contents, every tensor on the CPU.  Upstream's own
    files hold an ``argparse.Namespace`` and so cannot be read with
    ``weights_only``; the port's can, and are."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:  # a global that weights_only refuses
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt if isinstance(ckpt, dict) and "model" in ckpt else {"model": ckpt}


def resolve(path: str | Path) -> Path:
    """An explicit ``--resume``: a ``.pth`` file, or a directory: an output
    directory (its newest checkpoint of either format,
    :func:`latest_checkpoint`), or one of the JAX package's Orbax forms
    (``orbax_io._resolve_ckpt_root``): a ``checkpoints`` root (its newest
    step) or a step directory ``checkpoints/<epoch>``."""
    from . import orbax_io

    path = Path(path)
    if path.is_dir():
        root, epoch = orbax_io._resolve_ckpt_root(path)
        if epoch is not None:
            return path
        latest = latest_checkpoint(path)
        if latest is None and orbax_io.latest_epoch(root) is not None:
            return root / str(orbax_io.latest_epoch(root))
        if latest is None:
            raise FileNotFoundError(f"--resume {path}: no checkpoint-<epoch>.pth and no Orbax "
                                    "checkpoint in it")
        return latest
    if not path.exists():
        raise FileNotFoundError(f"--resume {path}: no such file")
    return path


def model_state(sd: Mapping, model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """``sd`` in the model's layout.  An upstream Minkowski checkpoint (its
    sparse encoder's ``*.kernel`` tensors) has its encoder remapped to the
    dense layout by :func:`remap_minkowski_keys`; GRN affines and a 1x1
    stem conv (the depthwise stem's or the original stem's) stored squeezed
    take the model's shape."""
    if any(k.startswith("encoder.") and k.endswith("kernel") for k in sd):
        enc = remap_minkowski_keys({k: _numpy(v) for k, v in sd.items()
                                    if k.startswith("encoder.")})
        sd = {**{k: v for k, v in sd.items() if not k.startswith("encoder.")},
              **{f"encoder.{k}": torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in enc.items()}}
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    out = {}
    for k, v in sd.items():
        v = torch.as_tensor(v)
        if k in shapes and (".grn." in k or k.endswith(("stem.0.weight", "stem_orig.0.weight"))):
            v = v.reshape(shapes[k])
        out[k] = v
    return out


def loader_state(path: str | Path, rank: int = 0) -> bytes | None:
    """The loader position stored in the checkpoint at ``path``, if any:
    ``rank``'s where it holds one a rank (a one-process file holds one,
    rank 0's)."""
    state = load(path).get("loader_state")
    if isinstance(state, list):
        state = state[rank]
    elif rank != 0 and state is not None:
        raise ValueError(f"{path} holds one process's loader position; rank {rank} has none")
    return None if state is None else state.numpy().tobytes()


def _numpy(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def restore(path: str | Path, model: torch.nn.Module, optimizer=None,
            ema: dict[str, torch.Tensor] | None = None, mesh=None) -> int | None:
    """Load the checkpoint at ``path`` into ``model`` (strictly), and into
    ``optimizer`` and ``ema`` where it holds their state.  Returns its epoch,
    or None for a file that holds the model alone, or an optimizer state of
    another layout (upstream's ``torch.optim`` one): the caller then keeps
    its ``--start_epoch``, as the JAX drivers' ``.pth`` resume does.  On a
    grid (``mesh``, a ``parallel/mesh.py::Mesh``) whose model axis splits
    leaves, each rank loads its slices of the file's whole leaves
    (``mesh.place_state``)."""
    ckpt = load(path)
    sd = model_state(ckpt["model"], model)
    opt_state = ckpt.get("optimizer")
    resumable = isinstance(opt_state, Mapping) and "mini_step" in opt_state and "epoch" in ckpt
    mesh_lib.place_state(model, optimizer if resumable else None, mesh, sd, opt_state)
    if not resumable:
        return None
    if ema is not None and "ema" in ckpt:
        theirs = mesh_lib.shard_state(ckpt["ema"], model, mesh)
        for name, t in ema.items():
            t.copy_(theirs[name])
    return int(ckpt["epoch"])

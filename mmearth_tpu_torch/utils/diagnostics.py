"""Environment diagnostics (port of ``mmearth_tpu/utils/diagnostics.py``;
reference diagnostics.py:19-66), in torch terms.

    python -m mmearth_tpu_torch.utils.diagnostics

Prints Python and the platform, torch and the CUDA it was built for, each
CUDA device's name, capability and memory, the process's rank and the
world size (JAX's ``process_index`` / ``process_count``: the process
group's where one is running, else torchrun's ``RANK`` / ``WORLD_SIZE``,
else 0 of 1), whether ``nvcc`` is on the path
(and its version), and which optional packages are installed, one
``name: version`` or ``name: not installed`` line each.  On a host without
CUDA it says so and does not raise.
"""
from __future__ import annotations

import importlib
import os
import platform
import shutil
import subprocess
import sys

OPTIONAL_PACKAGES = ("numpy", "h5py", "array_record", "tensorboardX", "matplotlib", "wandb",
                     "triton")


def nvcc_version() -> str | None:
    """The last line of ``nvcc --version``; None where nvcc is not on the path."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        return None
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout
    lines = out.strip().splitlines()
    return lines[-1].strip() if lines else "unknown"


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of this process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))


def print_diagnostics() -> None:
    print(f"python: {sys.version.split()[0]}  platform: {platform.platform()}")
    import torch

    print(f"torch: {torch.__version__}  cuda: {torch.version.cuda}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            print(f"  device: {p.name} (id {i}, capability {p.major}.{p.minor}, "
                  f"{p.total_memory / 2 ** 30:.1f} GiB)")
        print(f"devices: {torch.cuda.device_count()}")
    else:
        print("cuda: not available (no CUDA device)")
    rank, world = rank_and_world()
    print(f"rank: {rank}  world size: {world}")
    nvcc = nvcc_version()
    print(f"nvcc: {nvcc if nvcc is not None else 'not installed'}")
    for mod in OPTIONAL_PACKAGES:
        try:
            m = importlib.import_module(mod)
            print(f"{mod}: {getattr(m, '__version__', 'unknown')}")
        except ImportError:
            print(f"{mod}: not installed")


if __name__ == "__main__":
    print_diagnostics()

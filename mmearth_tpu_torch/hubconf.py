"""torch.hub entry of the PyTorch/CUDA port (the repo's root ``hubconf.py``
is the JAX package's):

    torch.hub.load("<repo>/mmearth_tpu_torch", "MPMAE", source="local",
                   ckpt_path="pt.pth", num_classes=10)

torch.hub puts this file's directory on ``sys.path``; the package is
imported from its parent.
"""
import sys
from pathlib import Path

dependencies = ["torch", "numpy"]

_ROOT = str(Path(__file__).resolve().parents[1])
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from mmearth_tpu_torch.hub import MPMAE  # noqa: E402,F401

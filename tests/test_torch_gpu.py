"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``gpu`` and skipped without a card; this file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch and nvcc:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from mmearth_tpu_torch.models.convnextv2 import visible_ids
from mmearth_tpu_torch.ops import patch_select as ps
from mmearth_tpu_torch.ops import wholeblock as wb

GRID, K = 7, 19


@pytest.mark.gpu
def test_kernels_match_plain_on_gpu():
    """The CUDA kernels against their plain versions (needs a GPU and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    order = np.argsort(np.random.default_rng(1).random((8, GRID * GRID)), axis=1)
    mask = torch.from_numpy((order >= K).astype(np.float32)).to(dev)
    kept, inv = visible_ids(mask, K)
    for p, c in ((8, 40), (4, 80), (2, 160), (1, 320)):
        h = GRID * p
        x = torch.randn(8, h, h, c, device=dev, dtype=torch.bfloat16)
        xg = ps._gather(x, kept, p, GRID)
        assert torch.equal(xg, ps.gather_patches_plain(x, kept, p, GRID))
        assert torch.equal(ps._scatter(xg, kept, inv, p, GRID, h),
                           ps.scatter_patches_plain(xg, kept, p, GRID, h))
        w, b = torch.randn(c, 1, 7, 7, device=dev), torch.randn(c, device=dev)
        ref = wb.dwconv7_gathered_plain(xg, kept, w, b, GRID).float()
        got = wb._fwd_cuda(xg, kept, inv, w, b, GRID).float()
        assert float((got - ref).abs().max()) <= 2 ** -6 * float(ref.abs().max())
        dx, dk, db = wb._bwd_cuda(xg, xg, kept, inv, w, GRID)
        rdx, rdk, rdb = wb.dwconv7_gathered_bwd_plain(xg, xg, kept, w, GRID)
        assert float((dx.float() - rdx.float()).abs().max()) <= 2 ** -6 * float(rdx.abs().max())
        torch.testing.assert_close(dk, rdk, rtol=1e-3, atol=1e-3 * float(rdk.abs().max()))
        torch.testing.assert_close(db, rdb, rtol=1e-3, atol=1e-3 * float(rdb.abs().max()))

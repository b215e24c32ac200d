"""Normalization layers for NHWC ConvNeXtV2 (port of ``mmearth_tpu/models/norm.py``).

  * ``LayerNorm``: over the channel axis, biased variance, eps 1e-6.
  * ``GRN``: dense Global Response Normalization, per-sample L2 over the
    spatial axes, eps 1e-4.
  * ``MaskedGRN``: the MinkowskiGRN semantics, L2 over the active sites of
    the batch (or of each group of ``group`` samples), eps 1e-6; with
    ``group`` 0 and a process group, over the global batch of every rank.

Statistics are f32 whatever the compute dtype.  As in flax's ``dtype``, the
params stay f32 and every output is cast to the layer's compute ``dtype``.
GRN affines are stored ``(1, 1, 1, C)``, the upstream dense layout.
"""
from __future__ import annotations

import warnings

import torch
from torch import nn

from ..parallel.mesh import all_reduce_sum


def _safe_l2(sum_sq: torch.Tensor) -> torch.Tensor:
    """sqrt with a zero gradient where ``sum_sq == 0`` (a dead channel would
    otherwise give an infinite derivative); the forward value is unchanged."""
    pos = sum_sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sum_sq, torch.ones_like(sum_sq))),
                       torch.zeros_like(sum_sq))


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) / torch.sqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)


class GRN(nn.Module):
    """Dense GRN over NHWC maps: per-sample spatial L2, eps 1e-4."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.dtype = dtype

    def forward(self, x):
        xf = x.float()
        gx = _safe_l2(xf.square().sum((1, 2), keepdim=True))
        nx = gx / (gx.mean(-1, keepdim=True) + 1e-4)
        return (self.gamma * (xf * nx) + self.beta + xf).to(self.dtype)


class MaskedGRN(nn.Module):
    """Batch L2 over visible sites, eps 1e-6.  ``keep`` (broadcastable to x's
    leading dims, 1 = visible) selects the sites that enter the statistic;
    output values at masked sites are not zeroed.

    ``group``: 0 = one statistic over the whole batch; > 0 = one per
    consecutive group of ``group`` samples (the per-device scope).  A batch
    that ``group`` does not divide warns and falls back to the whole batch.

    ``process_group`` (``parallel/mesh.py::set_process_group``): with
    ``group`` 0 the sum of squares is summed over its ranks before the
    square root, which is the global batch's statistic that JAX's sharded
    reduction computes (the global scope); ``group`` > 0 stays local to
    the rank, with no collective (the per-device scope)."""

    def __init__(self, dim: int, dtype=torch.float32, group: int = 0):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.dtype = dtype
        self.group = group
        self.process_group = None

    def cross_rank(self):
        """The process group the statistic is summed over, or None (one
        process, or the per-device scope)."""
        return self.process_group if self.group <= 0 else None

    def group_size(self, n: int, stacklevel: int = 3) -> int:
        """Samples per statistic for a batch of ``n``: ``group``, or ``n`` when
        ``group`` is 0 or does not divide ``n`` (which warns)."""
        if self.group > 0 and n % self.group:
            warnings.warn(
                f"MaskedGRN: batch {n} is not divisible by group {self.group}; "
                "falling back to global-batch statistics for this call",
                stacklevel=stacklevel,
            )
        return n if self.group <= 0 or n % self.group else min(self.group, n)

    def forward(self, x, keep=None):
        xf = x.float()
        masked = xf if keep is None else xf * keep.float()
        n = xf.shape[0]
        g = self.group_size(n)
        xg = xf.reshape(n // g, g, *xf.shape[1:])
        mg = masked.reshape(n // g, g, *masked.shape[1:])
        axes = tuple(range(1, mg.ndim - 1))
        gx = _safe_l2(all_reduce_sum(mg.square().sum(axes, keepdim=True), self.cross_rank()))
        nx = gx / (gx.mean(-1, keepdim=True) + 1e-6)
        c = xf.shape[-1]
        gamma = self.gamma.reshape(c)
        beta = self.beta.reshape(c)
        return (gamma * (xg * nx) + beta + xg).reshape(xf.shape).to(self.dtype)

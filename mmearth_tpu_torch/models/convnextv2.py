"""NHWC ConvNeXtV2 with the sparse encoders of pretraining (port of
``mmearth_tpu/models/convnextv2.py``).

The masked encoder reproduces the MinkowskiEngine sparse encoder in one of two
ways (``sparse_impl``), which compute the same function:

* ``gathered``: on the visible patches only.  The stem runs on the dense
  grid, its output is gathered onto the ``(N, K, p, p, C)`` rows of the K
  visible patches, every block's depthwise 7x7 conv runs through
  :func:`dwconv7_gathered` (at every stage, p = 8/4/2/1 at 56/8) and its
  site-local tail (LN -> Linear -> erf GELU -> MaskedGRN over all rows ->
  Linear -> residual) on the rows, the 2x2 stride-2 downsamples on the rows,
  and stage 4 is scattered back to the dense grid with zeros at removed
  patches.  It needs the same visible count K in every sample.
* ``masked_dense``: every op on the full grid, re-masked with the upsampled
  keep mask after the stem, each downsample and each block's tail (JAX
  ``_stages``, :679-696); the MaskedGRN statistic is over the kept sites.
  Any mask.

SAME padding, as the JAX package.

``block_impl``, as JAX routes it: on the gathered path ``auto``, ``xla``,
``dwg`` and ``fused`` run the block tail as composed torch ops, and ``spillg``
and ``wholeblock`` run it through :func:`fused_block_mlp_spillg` (the spill-g
kernels; in JAX ``wholeblock`` differs from ``spillg`` by also taking the
Pallas dwconv, which every gathered block of the port already runs).  On the
masked-dense path ``fused`` runs the tail through :func:`fused_block_mlp`
(the masked-dense kernels) and every other value composes it.  The param tree
is the same for every ``block_impl`` and ``sparse_impl``.

Params are f32 in upstream's dense layout and key names (OIHW convs, (out,
in) Linears, (1, 1, 1, C) GRN affines); each layer casts them to its compute
``dtype`` at use, as flax does.  No autocast.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_block import fused_block_mlp, fused_block_mlp_spillg
from ..ops.patch_select import gather_patches, scatter_patches
from ..ops.wholeblock import dwconv7_gathered
from .norm import GRN, LayerNorm, MaskedGRN

BLOCK_IMPLS = ("auto", "xla", "dwg", "spillg", "wholeblock", "fused")
SPILLG_IMPLS = ("spillg", "wholeblock")
SPARSE_IMPLS = ("gathered", "masked_dense")
_LATER_SLICE = {
    "remat": "the rematerialized block tail",
    "folded": "the norm-folded block tail",
}


# ---------------------------------------------------------------------------
# init (the JAX package's rules, convnextv2.py:49-53,362-363)
# ---------------------------------------------------------------------------
_TRUNC_STD = 0.87962566103423978  # std of a standard normal truncated to [-2, 2]


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal truncated at +-2 sigma and rescaled to std ``std`` (flax's
    ``truncated_normal(stddev)``), by the inverse CDF."""
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float64) * (1 - 2 * lo) + lo
    z = torch.erfinv(2 * u - 1) * math.sqrt(2)
    t.copy_((z.clamp_(-2, 2) * (std / _TRUNC_STD)).to(t.dtype))
    return t


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    t.copy_(torch.randn(t.shape, generator=generator, dtype=torch.float32) * std)
    return t


def init_param(t: torch.Tensor, kind: str, generator: torch.Generator) -> None:
    """kind: "trunc1" (trunc-normal std 1) | "normal02" (normal std .02) | "zeros"."""
    if kind == "trunc1":
        trunc_normal_(t, 1.0, generator)
    elif kind == "normal02":
        normal_(t, 0.02, generator)
    elif kind == "zeros":
        with torch.no_grad():
            t.zero_()
    else:
        raise ValueError(f"unknown init {kind!r}")


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------
def gelu(x):
    return F.gelu(x)  # exact erf GELU, torch nn.GELU() default


def dense(x, weight, bias, dtype):
    """flax ``Dense`` with ``dtype``: x @ W^T + b, all cast to ``dtype``."""
    return F.linear(x.to(dtype), weight.to(dtype), bias.to(dtype))


def conv_nhwc(x, conv: nn.Conv2d, dtype):
    """nn.Conv2d params applied to an NHWC map, in ``dtype``."""
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype), conv.bias.to(dtype),
                 conv.stride, conv.padding, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


def visible_ids(mask: torch.Tensor, num_visible: int):
    """From an (N, L) patch mask (1 = removed) with exactly ``num_visible``
    zeros per row: ``kept_ids`` (N, K) ascending visible patch ids and
    ``inv_ids`` (N, L), each patch's row in the gathered tensor or K where
    removed.  Both int32."""
    keep = (1 - mask).to(torch.int32)
    kept_ids = torch.argsort(mask, dim=1, stable=True)[:, :num_visible]
    rank = torch.cumsum(keep, dim=1) - 1
    inv_ids = torch.where(keep > 0, rank, torch.full_like(rank, num_visible))
    return kept_ids.to(torch.int32).contiguous(), inv_ids.to(torch.int32).contiguous()


def upsample_mask(mask: torch.Tensor, grid: int, size: int) -> torch.Tensor:
    """(N, L) patch mask -> (N, size, size, 1), nearest (reference fcmae.py:233-240)."""
    n = mask.shape[0]
    s = size // grid
    m = mask.reshape(n, grid, 1, grid, 1, 1).expand(n, grid, s, grid, s, 1)
    return m.reshape(n, size, size, 1)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
class Block(nn.Module):
    """ConvNeXtV2 block.  Dense form on an NHWC map (the decoder); gathered
    form on ``(N, K, p, p, C)`` visible rows when ``gather`` =
    ``(kept_ids, inv_ids, grid)`` is given; masked-dense form on an NHWC map
    whose masked sites are zero when ``keep`` (N, H, W, 1), 1 = visible, is
    given (JAX ``Block``, :506-543: the GRN statistic over the kept sites and
    the tail re-masked before the residual).  With ``spillg`` the gathered
    tail runs through :func:`fused_block_mlp_spillg`; with ``fused`` the
    masked-dense tail runs through :func:`fused_block_mlp`."""

    def __init__(self, dim: int, sparse: bool = False, dw_init: str | None = None,
                 pw_init: str | None = None, grn_group: int = 0, dtype=torch.float32,
                 spillg: bool = False, fused: bool = False):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, dtype=dtype)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = MaskedGRN(4 * dim, dtype, grn_group) if sparse else GRN(4 * dim, dtype)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.dtype = dtype
        self.spillg = spillg and sparse
        self.fused = fused and sparse
        default = "trunc1" if sparse else "normal02"
        self.inits = {"dwconv.weight": dw_init or default, "pwconv1.weight": pw_init or default,
                      "pwconv2.weight": pw_init or default}

    def forward(self, x, gather=None, keep=None):
        if gather is not None:
            kept_ids, inv_ids, grid = gather
            t = dwconv7_gathered(x.to(self.dtype).contiguous(), kept_ids, inv_ids,
                                 self.dwconv.weight, self.dwconv.bias, grid)
            if self.spillg:
                return self._spillg_tail(x, t)
        else:
            t = conv_nhwc(x, self.dwconv, self.dtype)
            if keep is not None and self.fused:
                return self._fused_tail(x, t, keep)
        u = gelu(dense(self.norm(t), self.pwconv1.weight, self.pwconv1.bias, self.dtype))
        u = self.grn(u) if keep is None else self.grn(u, keep)  # gathered: every row visible
        out = dense(u, self.pwconv2.weight, self.pwconv2.bias, self.dtype)
        return x + (out if keep is None else out * keep.to(out.dtype))

    def _fused_tail(self, x, t, keep):
        """The masked tail on the N*H*W sites, GRN grouped as ``MaskedGRN``
        groups them."""
        n, h, w, c = t.shape
        g = self.grn.group_size(n, stacklevel=4)
        rows = n * h * w
        y = fused_block_mlp(
            t.reshape(rows, c), x.reshape(rows, c), keep.reshape(rows, 1), self.norm.weight,
            self.norm.bias, self.pwconv1.weight, self.pwconv1.bias, self.grn.gamma, self.grn.beta,
            self.pwconv2.weight, self.pwconv2.bias, group_rows=g * h * w)
        return y.reshape(t.shape)

    def _spillg_tail(self, x, t):
        """The tail on the N*K*p*p rows, GRN grouped as ``MaskedGRN`` groups
        them (``MaskedGRN.group_size``)."""
        n, c = t.shape[0], t.shape[-1]
        g = self.grn.group_size(n, stacklevel=4)
        rows = t.numel() // c
        y = fused_block_mlp_spillg(
            t.reshape(rows, c), x.reshape(rows, c), self.norm.weight, self.norm.bias,
            self.pwconv1.weight, self.pwconv1.bias, self.grn.gamma, self.grn.beta,
            self.pwconv2.weight, self.pwconv2.bias, group_rows=g * (rows // n))
        return y.reshape(t.shape)


class ConvNeXtV2(nn.Module):
    """The masked encoder of FCMAE pretraining (SAME padding, dense stem)."""

    def __init__(self, patch_size: int = 8, img_size: int = 56, in_chans: int = 12,
                 depths=(2, 2, 6, 2), dims=(40, 80, 160, 320), grn_group: int = 0,
                 block_impl: str = "auto", sparse_impl: str = "gathered", dtype=torch.float32):
        super().__init__()
        if block_impl not in BLOCK_IMPLS:
            later = _LATER_SLICE.get(block_impl, "no slice")
            raise ValueError(f"block_impl={block_impl!r} is not in this port yet: it needs "
                             f"{later}, queued in ROADMAP.md; use one of {BLOCK_IMPLS}")
        if sparse_impl not in SPARSE_IMPLS:
            raise ValueError(f"sparse_impl={sparse_impl!r}: use one of {SPARSE_IMPLS}")
        self.sparse_impl = sparse_impl
        self.patch_size, self.img_size = patch_size, img_size
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.dtype = dtype
        s = self.stem_stride
        self.initial_conv = nn.Sequential(nn.Conv2d(in_chans, dims[0], 3, padding=1),
                                          LayerNorm(dims[0], dtype=dtype))
        self.stem = nn.Sequential(nn.Conv2d(dims[0], dims[0], s, stride=s, groups=dims[0]),
                                  LayerNorm(dims[0], dtype=dtype))
        self.downsample_layers = nn.ModuleList(
            nn.Sequential(LayerNorm(dims[i], dtype=dtype),
                          nn.Conv2d(dims[i], dims[i + 1], 2, stride=2))
            for i in range(3))
        self.stages = nn.ModuleList(
            nn.Sequential(*[Block(dims[i], sparse=True, grn_group=grn_group, dtype=dtype,
                                  spillg=block_impl in SPILLG_IMPLS,
                                  fused=block_impl == "fused")
                            for _ in range(depths[i])])
            for i in range(4))

    @property
    def stem_stride(self) -> int:
        return self.patch_size // (2 ** (len(self.depths) - 1))

    def init_weights(self, generator: torch.Generator) -> None:
        """Conv/Linear weights by the JAX package's rules, every bias zero (LN
        scales and GRN affines keep their constructor values)."""
        for name, prm in self.named_parameters():
            if name.endswith(".weight") and prm.ndim > 1:
                init_param(prm, self._init_kind(name), generator)
            elif name.endswith(".bias"):
                init_param(prm, "zeros", generator)

    def _init_kind(self, name: str) -> str:
        if name.startswith("stem."):
            return "trunc1"  # sparse depthwise stem
        if name.startswith("stages."):
            i, j, rest = name.split(".", 3)[1:]
            return self.stages[int(i)][int(j)].inits[rest]
        return "normal02"  # initial conv, downsamples

    def _stem(self, x, keep_pixel, keep_stem):
        x = self.initial_conv[1](conv_nhwc(x, self.initial_conv[0], self.dtype))
        x = gelu(x * keep_pixel.to(x.dtype))
        x = self.stem[1](conv_nhwc(x, self.stem[0], self.dtype))
        return x * keep_stem.to(x.dtype)

    def _downsample(self, xg, i: int):
        """LN then the 2x2 stride-2 conv on (N, K, p, p, C) rows, as a Linear
        over each 2x2 window."""
        norm, conv = self.downsample_layers[i]
        y = norm(xg)
        n, k, p, _, c = y.shape
        q = p // 2
        y = y.reshape(n, k, q, 2, q, 2, c).permute(0, 1, 2, 4, 3, 5, 6).reshape(n, k, q, q, 4 * c)
        w = conv.weight.permute(0, 2, 3, 1).reshape(conv.weight.shape[0], 4 * c)
        return dense(y, w, conv.bias, self.dtype)

    def _stages(self, x, keeps):
        """The four stages on the masked dense grid; ``keeps`` holds each
        stage's (N, H, W, 1) keep mask (JAX ``_stages``, :679-696)."""
        for i, stage in enumerate(self.stages):
            if i:
                norm, conv = self.downsample_layers[i - 1]
                x = conv_nhwc(norm(x), conv, self.dtype)
                x = x * keeps[i].to(x.dtype)
            for blk in stage:
                x = blk(x, keep=keeps[i])
        return x

    def encode(self, x, mask, num_visible: int | None = None):
        """Masked encoding: ``x`` (N, H, W, in_chans), ``mask`` (N, L) with 1 =
        removed.  Returns the dense stage-4 map (N, grid, grid, dims[-1]), zero
        at masked sites.  ``num_visible``: the visible count of every row; the
        gathered path needs it, and without it (or with ``sparse_impl =
        "masked_dense"``) the masked-dense path runs, as in JAX (:808-815)."""
        grid = self.img_size // self.patch_size
        h = self.img_size // self.stem_stride
        keep_flat = 1.0 - mask.float()
        keep_pixel = upsample_mask(keep_flat, grid, self.img_size)
        x = x * keep_pixel.to(x.dtype)
        if num_visible is None or self.sparse_impl == "masked_dense":
            keeps = [upsample_mask(keep_flat, grid, h >> i) for i in range(len(self.stages))]
            return self._stages(self._stem(x, keep_pixel, keeps[0]), keeps)
        kept_ids, inv_ids = visible_ids(mask, num_visible)
        ctx = (kept_ids, inv_ids, grid)
        y = self._stem(x, keep_pixel, upsample_mask(keep_flat, grid, h)).contiguous()
        xg = gather_patches(y, kept_ids, inv_ids, h // grid, grid)
        for i, stage in enumerate(self.stages):
            if i:
                xg = self._downsample(xg, i - 1)
                h //= 2
            for blk in stage:
                xg = blk(xg, ctx)
        return scatter_patches(xg.contiguous(), kept_ids, inv_ids, h // grid, grid, h)

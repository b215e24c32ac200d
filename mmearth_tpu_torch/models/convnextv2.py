"""NHWC ConvNeXtV2 with the sparse encoders of pretraining and the dense
classifier of finetuning (port of ``mmearth_tpu/models/convnextv2.py``).

The dense classifier (``sparse=False`` with ``num_classes`` > 0) runs every
block on the full grid, its depthwise 7x7 conv through :func:`dwconv7x7`
(the hand-written weight gradient), with per-block drop path, then GAP ->
LN -> head.  The same dense trunk is the "leaky" pretraining encoder
(``sparse=False`` in FCMAE, JAX :803-806): the mask is applied to the input
only, then the dense stem and stages run (no norm, no head).

The masked encoder reproduces the MinkowskiEngine sparse encoder in one of two
ways (``sparse_impl``), which compute the same function:

* ``gathered``: on the visible patches only.  The stem runs on the dense
  grid, its output is gathered onto the ``(N, K, p, p, C)`` rows of the K
  visible patches, every block's depthwise 7x7 conv runs through
  :func:`dwconv7_gathered` (at every stage: p = 8/4/2/1 at 56/8, 16/8/4/2 at
  112/16) and its
  site-local tail (LN -> Linear -> GELU -> MaskedGRN over all rows ->
  Linear -> residual) on the rows, the 2x2 stride-2 downsamples on the rows,
  and stage 4 is scattered back to the dense grid with zeros at removed
  patches.  It needs the same visible count K in every sample.  With
  ``stem_gathered`` the stem's site-local part runs on the gathered rows
  too (JAX :751-766): the initial conv's output is gathered (the original
  stem, patch-local, gathers the raw input) and the rest of the stem runs
  on the rows.  Whichever of the two, the 3x3-conv stem with the erf GELU
  (not ``use_orig_stem``, not ``gelu_approx``) runs its site-local part as
  :func:`stem_rows` on the visible patches of the initial conv's output:
  the same rows, with the stem and the gather after it one kernel pair on a
  card.
* ``masked_dense``: every op on the full grid, re-masked with the upsampled
  keep mask after the stem, each downsample and each block's tail (JAX
  ``_stages``, :679-696); the MaskedGRN statistic is over the kept sites.
  Every block's depthwise conv runs through :func:`dwconv7x7`.  Any mask.

The stem is the 3x3 initial conv -> LN -> GELU -> depthwise stride-s conv ->
LN, or with ``use_orig_stem`` upstream's original stem, one s x s stride-s
conv -> LN (JAX :600-606), s = patch / 8.  The GELU is the exact erf one, or
the tanh one with ``gelu_approx`` (stem, block tails; JAX :56-60).

SAME padding, as the JAX package (the classifier also takes upstream's
``padding_mode="reference"``).

``block_impl``, as JAX routes it: on the gathered path ``auto``, ``xla``,
``dwg`` and ``fused`` run the block tail as composed torch ops, ``spillg``
and ``wholeblock`` run it through :func:`fused_block_mlp_spillg` (the spill-g
kernels; in JAX ``wholeblock`` differs from ``spillg`` by also taking the
Pallas dwconv, which every gathered block of the port already runs), and
``folded`` folds LN into the first product and the GRN affine into the
second (JAX ``_folded_tail``, :183-260).  On the masked-dense path ``fused``
runs the tail through :func:`fused_block_mlp` (the masked-dense kernels) and
every other value composes it.  The kernels hard-code the erf GELU, so under
``gelu_approx`` the blocks compose their tails instead, as JAX declines its
kernels (:326-327,347-348).  ``remat`` composes the tail under
``torch.utils.checkpoint`` in every form (JAX :370-412), the depthwise conv
outside it.  The param tree is the same for every ``block_impl`` and
``sparse_impl``.

Params are f32 in upstream's dense layout and key names (OIHW convs, (out,
in) Linears, (1, 1, 1, C) GRN affines); each layer casts them to its compute
``dtype`` at use, as flax does.  No autocast.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.dwconv import dwconv7x7
from ..ops.fused_block import fused_block_mlp, fused_block_mlp_spillg
from ..parallel.mesh import all_reduce_sum, column_linear, gather_shards, shard_rows, world_size
from ..ops.patch_select import gather_patches, scatter_patches
from ..ops.stem import stem_rows
from ..ops.stem import supported as stem_rows_supported
from ..ops.wholeblock import dwconv7_gathered
from .norm import GRN, LayerNorm, MaskedGRN, _safe_l2

BLOCK_IMPLS = ("auto", "xla", "dwg", "spillg", "wholeblock", "fused", "remat", "folded")
SPILLG_IMPLS = ("spillg", "wholeblock")
SPARSE_IMPLS = ("gathered", "masked_dense")


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
def gelu(x, approximate: bool = False):
    """The exact erf GELU (torch nn.GELU()'s default, the reference's), or
    the tanh one (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def dense(x, weight, bias, dtype):
    """flax ``Dense`` with ``dtype``: x @ W^T + b, all cast to ``dtype``."""
    return F.linear(x.to(dtype), weight.to(dtype), bias.to(dtype))


def column_dense(x, weight, bias, dtype, width: int, group):
    """:func:`dense` of a leaf of ``width`` output channels, of which this
    rank may hold a shard (``parallel/mesh.py::shard_params``): then
    column-parallel over the model ``group`` (``mesh.column_linear``)."""
    return column_linear(x.to(dtype), weight.to(dtype), bias.to(dtype), width, group)


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
class DropPath(nn.Module):
    """Per-sample stochastic depth (JAX ``DropPath``, :263-276): each sample's
    branch is kept with probability 1 - rate and scaled by 1 / (1 - rate).
    The identity at rate 0 or without a ``generator`` (evaluation).  Under
    a ``process_group`` the draw is the global batch's (the ranks' batches
    in rank order, from the same generator state on every rank), of which
    the rank keeps its own rows, as JAX draws for the sharded batch."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.process_group = None

    def forward(self, x, generator: torch.Generator | None = None):
        if self.rate == 0.0 or generator is None:
            return x
        keep = 1.0 - self.rate
        n = x.shape[0]
        shape = (n * world_size(self.process_group),) + (1,) * (x.ndim - 1)
        start, stop = shard_rows(n, self.process_group)
        mask = torch.rand(shape, generator=generator, device=x.device)[start:stop] < keep
        return x * mask.to(x.dtype) / keep


class Block(nn.Module):
    """ConvNeXtV2 block.  Dense form on an NHWC map (the decoder, the
    classifier and the leaky encoder); gathered form on ``(N, K, p, p, C)``
    visible rows when ``gather`` = ``(kept_ids, inv_ids, grid)`` is given;
    masked-dense form on an NHWC map whose masked sites are zero when
    ``keep`` (N, H, W, 1), 1 = visible, is given (JAX ``Block``, :506-543:
    the GRN statistic over the kept sites and the tail re-masked before the
    residual).  The dense and masked-dense forms run their depthwise conv
    through :func:`dwconv7x7`, the gathered form through
    :func:`dwconv7_gathered`.  The tail after it: with ``spillg`` the
    gathered tail runs through :func:`fused_block_mlp_spillg`, with
    ``fused`` the masked-dense tail through :func:`fused_block_mlp`, with
    ``folded`` the gathered tail folds the norms into the products
    (:meth:`_folded_tail`); every other tail is composed, under
    ``torch.utils.checkpoint`` with ``remat``.  Under ``gelu_approx`` (the
    tanh GELU) neither kernel tail is taken, as the kernels compute the erf
    GELU.  The tail ends in :class:`DropPath` (``drop_path`` > 0 only in the
    classifier, whose blocks take neither kernel tail).  Under the global
    GRN scope with a process group (``MaskedGRN.cross_rank``), every tail
    takes the statistic over the ranks: the kernel tails are given the
    group, the composed and folded ones sum through ``all_reduce_sum``.

    On a grid whose ``model`` axis splits ``pwconv1`` (``model_group``, from
    ``parallel/mesh.py::set_process_group``), the composed tails run it
    column-parallel (:func:`column_dense`) and the folded and kernel tails
    take its weight and bias whole (``mesh.gather_shards``), giving back
    the rank's slice of their gradients."""

    def __init__(self, dim: int, sparse: bool = False, dw_init: str | None = None,
                 pw_init: str | None = None, grn_group: int = 0, dtype=torch.float32,
                 spillg: bool = False, fused: bool = False, drop_path: float = 0.0,
                 gelu_approx: bool = False, remat: bool = False, folded: bool = False):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim, dtype=dtype)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = MaskedGRN(4 * dim, dtype, grn_group) if sparse else GRN(4 * dim, dtype)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.drop_path = DropPath(drop_path)
        self.dtype = dtype
        self.gelu_approx = gelu_approx
        self.spillg = spillg and sparse and not gelu_approx
        self.fused = fused and sparse and not gelu_approx
        self.folded = folded and sparse
        self.remat = remat
        self.model_group = None
        default = "trunc1" if sparse else "normal02"
        self.inits = {"dwconv.weight": dw_init or default, "pwconv1.weight": pw_init or default,
                      "pwconv2.weight": pw_init or default}

    def forward(self, x, gather=None, keep=None, generator: torch.Generator | None = None):
        if gather is not None:
            kept_ids, inv_ids, grid = gather
            t = dwconv7_gathered(x.to(self.dtype).contiguous(), kept_ids, inv_ids,
                                 self.dwconv.weight, self.dwconv.bias, grid)
            if self.spillg:
                return self._spillg_tail(x, t)
            if self.folded:
                return x + self.drop_path(self._folded_tail(t), generator)
        else:
            t = dwconv7x7(x.to(self.dtype), self.dwconv.weight, self.dwconv.bias)
            if keep is not None and self.fused:
                return self._fused_tail(x, t, keep)
        if self.remat:
            # The branch draws nothing (drop path is applied after it), so
            # its recompute needs no saved RNG state, and a CUDA graph can
            # capture it (preserve_rng_state would read the generator).
            out = checkpoint(self._branch, t, keep, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            out = self._branch(t, keep)
        return x + self.drop_path(out, generator)

    def _branch(self, t, keep=None):
        """The composed tail before drop path: LN -> pw1 -> GELU -> GRN ->
        pw2, re-masked with ``keep`` when given."""
        u = gelu(column_dense(self.norm(t), self.pwconv1.weight, self.pwconv1.bias, self.dtype,
                              self.pwconv1.out_features, self.model_group), self.gelu_approx)
        u = self.grn(u) if keep is None else self.grn(u, keep)  # gathered: every row visible
        out = dense(u, self.pwconv2.weight, self.pwconv2.bias, self.dtype)
        return out if keep is None else out * keep.to(out.dtype)

    def _folded_tail(self, t):
        """The gathered tail with the two norms folded into the products
        (JAX ``_folded_tail``, :183-260): LN as ``t (W1 diag(ln_w))^T``
        corrected per row by the mean and the inverse deviation in f32, and
        the GRN affine of each GRN group as the columns of W2 scaled by
        ``gamma * nx + 1``.  The Linear weights are (out, in), the transposes
        of JAX's kernels, so the scales fall on their columns.  As in JAX the
        first product's output is in the compute dtype, upcast in the f32
        correction."""
        f32, dt = torch.float32, self.dtype
        w1, b1 = self._pw1_whole()
        n, c4 = t.shape[0], w1.shape[0]
        tf = t.float()
        mu = tf.mean(-1, keepdim=True)
        inv = torch.rsqrt((tf - mu).square().mean(-1, keepdim=True) + self.norm.eps)
        w1 = w1.float()
        w1p = w1 * self.norm.weight.float()
        bias1 = F.linear(self.norm.bias.float(), w1, b1.float())
        z = F.linear(t.to(dt), w1p.to(dt))
        g = gelu((z.to(f32) - mu * w1p.sum(1)) * inv + bias1, self.gelu_approx).to(dt)
        grp = self.grn.group_size(n, stacklevel=4)
        gg = g.reshape(n // grp, -1, c4)
        gx = _safe_l2(all_reduce_sum(gg.to(f32).square().sum(1), self.grn.cross_rank()))
        nx = gx / (gx.mean(-1, keepdim=True) + 1e-6)
        w2 = self.pwconv2.weight.float()
        a = self.grn.gamma.reshape(c4).float() * nx + 1.0
        bias2 = F.linear(self.grn.beta.reshape(c4).float(), w2, self.pwconv2.bias.float())
        w2p = (a[:, None, :] * w2).to(dt)  # (groups, C, 4C)
        out = torch.matmul(gg, w2p.transpose(1, 2)) + bias2.to(dt)
        return out.to(dt).reshape(t.shape)

    def _pw1_whole(self):
        """``pwconv1``'s weight and bias whole (gathered where this rank holds
        a shard of them)."""
        c4 = self.pwconv1.out_features
        return (gather_shards(self.pwconv1.weight, c4, self.model_group),
                gather_shards(self.pwconv1.bias, c4, self.model_group))

    def _fused_tail(self, x, t, keep):
        """The masked tail on the N*H*W sites, GRN grouped as ``MaskedGRN``
        groups them."""
        n, h, w, c = t.shape
        g = self.grn.group_size(n, stacklevel=4)
        rows = n * h * w
        w1, b1 = self._pw1_whole()
        y = fused_block_mlp(
            t.reshape(rows, c), x.reshape(rows, c), keep.reshape(rows, 1), self.norm.weight,
            self.norm.bias, w1, b1, self.grn.gamma, self.grn.beta,
            self.pwconv2.weight, self.pwconv2.bias, group_rows=g * h * w,
            process_group=self.grn.cross_rank())
        return y.reshape(t.shape)

    def _spillg_tail(self, x, t):
        """The tail on the N*K*p*p rows, GRN grouped as ``MaskedGRN`` groups
        them (``MaskedGRN.group_size``)."""
        n, c = t.shape[0], t.shape[-1]
        g = self.grn.group_size(n, stacklevel=4)
        rows = t.numel() // c
        w1, b1 = self._pw1_whole()
        y = fused_block_mlp_spillg(
            t.reshape(rows, c), x.reshape(rows, c), self.norm.weight, self.norm.bias,
            w1, b1, self.grn.gamma, self.grn.beta,
            self.pwconv2.weight, self.pwconv2.bias, group_rows=g * (rows // n),
            process_group=self.grn.cross_rank())
        return y.reshape(t.shape)


class ConvNeXtV2(nn.Module):
    """ConvNeXtV2: the masked encoder of FCMAE pretraining (``sparse``, the
    default), the leaky dense encoder (``sparse=False``, no head), or the
    dense classifier that GEO-Bench finetuning trains (``sparse=False`` and
    ``num_classes`` > 0: dense stem and stages, GAP -> LN -> ``head``, JAX
    :817-826).  ``padding_mode`` "same" pads every conv SAME; "reference"
    (dense only) runs the initial 3x3 conv VALID and pads the stem s//2 on
    each side, as upstream's dense model (JAX :607-623); the original stem
    (``use_orig_stem``) is VALID in both."""

    def __init__(self, patch_size: int = 8, img_size: int = 56, in_chans: int = 12,
                 depths=(2, 2, 6, 2), dims=(40, 80, 160, 320), grn_group: int = 0,
                 block_impl: str = "auto", sparse_impl: str = "gathered", dtype=torch.float32,
                 sparse: bool = True, num_classes: int = 0, drop_path_rate: float = 0.0,
                 head_init_scale: float = 1.0, padding_mode: str = "same",
                 use_orig_stem: bool = False, gelu_approx: bool = False,
                 stem_gathered: bool = False):
        super().__init__()
        if block_impl not in BLOCK_IMPLS:
            raise ValueError(f"block_impl={block_impl!r}: use one of {BLOCK_IMPLS}")
        if sparse_impl not in SPARSE_IMPLS:
            raise ValueError(f"sparse_impl={sparse_impl!r}: use one of {SPARSE_IMPLS}")
        if padding_mode not in ("same", "reference"):
            raise ValueError(f"padding_mode must be 'same' or 'reference', got {padding_mode!r}")
        if padding_mode == "reference" and sparse:
            raise ValueError("padding_mode='reference' is dense-only (masked path needs SAME "
                             "alignment)")
        self.sparse, self.sparse_impl = sparse, sparse_impl
        self.patch_size, self.img_size = patch_size, img_size
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.head_init_scale = head_init_scale
        self.dtype = dtype
        self.use_orig_stem, self.gelu_approx = use_orig_stem, gelu_approx
        self.stem_gathered = stem_gathered
        s = self.stem_stride
        if use_orig_stem:
            self.stem_orig = nn.Sequential(nn.Conv2d(in_chans, dims[0], s, stride=s),
                                           LayerNorm(dims[0], dtype=dtype))
        else:
            ref_pad = padding_mode == "reference"
            self.initial_conv = nn.Sequential(
                nn.Conv2d(in_chans, dims[0], 3, padding=0 if ref_pad else 1),
                LayerNorm(dims[0], dtype=dtype))
            self.stem = nn.Sequential(nn.Conv2d(dims[0], dims[0], s, stride=s, groups=dims[0],
                                                padding=s // 2 if ref_pad else 0),
                                      LayerNorm(dims[0], dtype=dtype))
        self.downsample_layers = nn.ModuleList(
            nn.Sequential(LayerNorm(dims[i], dtype=dtype),
                          nn.Conv2d(dims[i], dims[i + 1], 2, stride=2))
            for i in range(3))
        rates = iter(float(r) for r in np.linspace(0.0, drop_path_rate, sum(depths)))
        self.stages = nn.ModuleList(
            nn.Sequential(*[Block(dims[i], sparse=sparse, grn_group=grn_group, dtype=dtype,
                                  spillg=block_impl in SPILLG_IMPLS,
                                  fused=block_impl == "fused", drop_path=next(rates),
                                  gelu_approx=gelu_approx, remat=block_impl == "remat",
                                  folded=block_impl == "folded")
                            for _ in range(depths[i])])
            for i in range(4))
        self.classifier = not sparse and num_classes > 0
        if self.classifier:
            self.norm = LayerNorm(dims[-1], dtype=dtype)
            self.head = nn.Linear(dims[-1], num_classes)

    @property
    def stem_stride(self) -> int:
        return self.patch_size // (2 ** (len(self.depths) - 1))

    def init_weights(self, generator: torch.Generator) -> None:
        """Conv/Linear weights by the JAX package's rules, every bias zero (LN
        scales and GRN affines keep their constructor values); the head's
        normal(0.02) weight times ``head_init_scale`` (JAX :647-653)."""
        for name, prm in self.named_parameters():
            if name.endswith(".weight") and prm.ndim > 1:
                init_param(prm, self._init_kind(name), generator)
            elif name.endswith(".bias"):
                init_param(prm, "zeros", generator)
        if self.classifier:
            with torch.no_grad():
                self.head.weight.mul_(self.head_init_scale)

    def _init_kind(self, name: str) -> str:
        if name.startswith("stem."):
            return "trunc1" if self.sparse else "normal02"  # depthwise stem
        if name.startswith("stages."):
            i, j, rest = name.split(".", 3)[1:]
            return self.stages[int(i)][int(j)].inits[rest]
        return "normal02"  # initial conv, original stem, downsamples, head

    def _stem(self, x, keep_pixel=None, keep_stem=None):
        """initial conv -> LN -> GELU -> depthwise stem -> LN (or the
        original stem's conv -> LN), re-masked with the keep masks when given
        (the masked encoder)."""
        if self.use_orig_stem:
            x = self.stem_orig[1](conv_nhwc(x, self.stem_orig[0], self.dtype))
        else:
            x = self.initial_conv[1](conv_nhwc(x, self.initial_conv[0], self.dtype))
            if keep_pixel is not None:
                x = x * keep_pixel.to(x.dtype)
            x = self.stem[1](conv_nhwc(gelu(x, self.gelu_approx), self.stem[0], self.dtype))
        return x if keep_stem is None else x * keep_stem.to(x.dtype)

    def _stem_rows(self, x, kept_ids, inv_ids, grid: int):
        """The stem with its site-local part on the gathered rows
        (``stem_gathered``, JAX :751-766): the original stem, patch-local,
        on the gathered input; else the initial conv on the dense grid, then
        LN -> GELU -> depthwise stem -> LN on its gathered rows.  Returns
        (N, K, p0, p0, dims[0])."""
        p_in, s = self.img_size // grid, self.stem_stride
        if self.use_orig_stem:
            conv, norm = self.stem_orig
            xg = gather_patches(x.contiguous(), kept_ids, inv_ids, p_in, grid)
        else:
            y = conv_nhwc(x, self.initial_conv[0], self.dtype).contiguous()
            xg = gelu(self.initial_conv[1](gather_patches(y, kept_ids, inv_ids, p_in, grid)),
                      self.gelu_approx)
            conv, norm = self.stem
        n, k = xg.shape[:2]
        y = norm(conv_nhwc(xg.reshape(n * k, p_in, p_in, xg.shape[-1]), conv, self.dtype))
        return y.reshape(n, k, p_in // s, p_in // s, y.shape[-1])

    @property
    def stem_kernel(self) -> bool:
        """Whether the gathered encoder's stem goes through
        :func:`stem_rows` (:meth:`_stem_kernel_rows`): the 3x3-conv stem with
        the erf GELU, at a width and stride the kernels take."""
        return (not self.use_orig_stem and not self.gelu_approx
                and stem_rows_supported(self.dims[0], self.stem_stride))

    def _stem_kernel_rows(self, x, kept_ids, inv_ids, grid: int):
        """The initial conv on the dense grid, then LN -> GELU -> depthwise
        stem -> LN on its visible patches as :func:`stem_rows`: the rows of
        :meth:`_stem_rows` and of :meth:`_stem` gathered."""
        conv, norm1 = self.initial_conv
        taps, norm2 = self.stem
        y = conv_nhwc(x, conv, self.dtype).contiguous()
        return stem_rows(y, kept_ids, inv_ids, grid, self.stem_stride, norm1.weight, norm1.bias,
                         taps.weight, taps.bias, norm2.weight, norm2.bias, norm1.eps, norm2.eps)

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

    def _stages(self, x, keeps=None, generator: torch.Generator | None = None):
        """The four stages on the dense grid (JAX ``_stages``, :679-696):
        masked when ``keeps`` holds each stage's (N, H, W, 1) keep mask,
        plain dense (the classifier, drop path drawn from ``generator``)
        without."""
        for i, stage in enumerate(self.stages):
            keep = None if keeps is None else keeps[i]
            if i:
                norm, conv = self.downsample_layers[i - 1]
                x = conv_nhwc(norm(x), conv, self.dtype)
                if keep is not None:
                    x = x * keep.to(x.dtype)
            for blk in stage:
                x = blk(x, keep=keep, generator=generator)
        return x

    def encode(self, x, mask, num_visible: int | None = None):
        """Masked encoding: ``x`` (N, H, W, in_chans), ``mask`` (N, L) with 1 =
        removed.  Returns the dense stage-4 map (N, grid, grid, dims[-1]), zero
        at masked sites on the sparse paths.  ``num_visible``: the visible
        count of every row; the gathered path needs it, and without it (or
        with ``sparse_impl = "masked_dense"``) the masked-dense path runs, as
        in JAX (:808-815).  The leaky encoder (``sparse=False``) masks the
        input only and runs the dense stem and stages (JAX :803-806)."""
        grid = self.img_size // self.patch_size
        h = self.img_size // self.stem_stride
        keep_flat = 1.0 - mask.float()
        keep_pixel = upsample_mask(keep_flat, grid, self.img_size)
        x = x * keep_pixel.to(x.dtype)
        if not self.sparse:
            return self._stages(self._stem(x))
        if num_visible is None or self.sparse_impl == "masked_dense":
            keeps = [upsample_mask(keep_flat, grid, h >> i) for i in range(len(self.stages))]
            return self._stages(self._stem(x, keep_pixel, keeps[0]), keeps)
        kept_ids, inv_ids = visible_ids(mask, num_visible)
        ctx = (kept_ids, inv_ids, grid)
        if self.stem_kernel:
            xg = self._stem_kernel_rows(x, kept_ids, inv_ids, grid)
        elif self.stem_gathered:
            xg = self._stem_rows(x, kept_ids, inv_ids, grid)
        else:
            y = self._stem(x, keep_pixel, upsample_mask(keep_flat, grid, h)).contiguous()
            xg = gather_patches(y, kept_ids, inv_ids, h // grid, grid)
        for i, stage in enumerate(self.stages):
            if i:
                xg = self._downsample(xg, i - 1)
                h //= 2
            for blk in stage:
                xg = blk(xg, ctx)
        return scatter_patches(xg.contiguous(), kept_ids, inv_ids, h // grid, grid, h)

    def forward_features(self, x, generator: torch.Generator | None = None):
        """The classifier's pooled features: dense stem and stages, global
        average pool, then LN (JAX :817-820)."""
        x = self._stages(self._stem(x), generator=generator)
        return self.norm(x.mean((1, 2)))

    def forward(self, x, generator: torch.Generator | None = None):
        """Classifier logits of ``x`` (N, H, W, in_chans), in the compute
        dtype.  ``generator`` draws the drop-path masks; without it every
        block keeps its branch (evaluation)."""
        return dense(self.forward_features(x, generator), self.head.weight, self.head.bias,
                     self.dtype)

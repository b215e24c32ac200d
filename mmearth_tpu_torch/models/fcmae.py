"""FCMAE, the multi-modal masked autoencoder of MP-MAE (port of
``mmearth_tpu/models/fcmae.py``).

  * encoder: the sparse ConvNeXtV2 (models/convnextv2.py), gathered or
    masked-dense (``sparse_impl``); an explicit mask whose rows do not all
    keep the generated visible count takes the masked-dense path, as in JAX
    (fcmae.py:214-226).  ``sparse=False`` is the reference's leaky dense
    encoder instead (the mask on the input only), ``use_orig_stem`` the
    original stem, ``stem_gathered`` the stem on the gathered rows and
    ``gelu_approx`` the tanh GELU in the encoder and the decoder Block;
  * 1x1 projection to the decoder dim and a learnable mask token blended into
    the masked sites (reference fcmae.py:113-118, 252-255);
  * decoder: upstream registers one list of Blocks under every modality name
    (fcmae.py:119-137), so its params are shared and every per-modality decode
    computes the same features.  The shared stack runs once here and is
    registered under every name, so the state dict has upstream's keys;
  * heads: 1x1 conv to p^2*C for pixel modalities; a shared LN + mean pool +
    Linear for image-level ones (fcmae.py:138-151, 256-265);
  * the multi-pretext loss with uncertainty weights (``loss_fn.log_vars``).

Under a process group (``process_group``, given by
``parallel/mesh.py::set_process_group`` to this module and its MaskedGRNs),
the loss is the global batch's and, under the global GRN scope
(``grn_group`` 0), so is every block's GRN statistic: each rank computes
what JAX computes on the ranks' batches concatenated in rank order.  On a
grid with a ``model`` axis (``parallel/mesh.py::shard_params``) the process
group is the data group, and ``proj`` and the heads whose output channels
the axis splits run column-parallel over ``model_group``
(``convnextv2.column_dense``), as the Blocks' ``pwconv1`` do.

Inputs and targets are NHWC dicts keyed by modality.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from ..configs import modalities as M
from ..losses.multipretext import multipretext_loss, uncertainty_weighted, unweighted
from .convnextv2 import Block, ConvNeXtV2, column_dense, init_param
from .norm import LayerNorm

PIXEL_HEAD_MODALITIES = (
    "sentinel2", "sentinel1", "aster", "canopy_height_eth",
    "dynamic_world", "esa_worldcover", "IMNET",
)


def gen_random_mask(n: int, num_patches: int, mask_ratio: float, generator: torch.Generator,
                    device=None) -> torch.Tensor:
    """(N, L) float mask, 1 = removed, exactly ``int(L*(1-ratio))`` zeros per
    row (reference fcmae.py:214-231: noise + double argsort)."""
    noise = torch.randn(n, num_patches, generator=generator, device=device)
    return mask_from_noise(noise, mask_ratio)


def mask_from_noise(noise: torch.Tensor, mask_ratio: float) -> torch.Tensor:
    """The mask of :func:`gen_random_mask` from its (N, L) noise: the
    ``int(L*(1-ratio))`` patches of lowest noise in each row are kept."""
    n, num_patches = noise.shape
    len_keep = int(num_patches * (1 - mask_ratio))
    ids_restore = torch.argsort(torch.argsort(noise, dim=1), dim=1)
    base = (torch.arange(num_patches, device=noise.device) >= len_keep).float()
    return torch.gather(base.expand(n, num_patches), 1, ids_restore)


def aligned_random_crop(imgs_dict: Mapping[str, torch.Tensor], img_size: int,
                        generator: Optional[torch.Generator] = None,
                        tops: Optional[torch.Tensor] = None,
                        lefts: Optional[torch.Tensor] = None,
                        pixel_wise=tuple(M.PIXEL_WISE_MODALITIES)) -> dict:
    """Random crop with the same per-sample offsets for every pixel-wise
    modality (reference fcmae.py:418-434), by exact indexing.  ``tops`` and
    ``lefts`` (N,) override the offsets drawn from ``generator``."""
    keys = [k for k in imgs_dict if k in pixel_wise and imgs_dict[k].ndim == 4]
    if not keys:
        return dict(imgs_dict)
    n, h, w = imgs_dict[keys[0]].shape[:3]
    if h == img_size and w == img_size:
        return dict(imgs_dict)
    dev = imgs_dict[keys[0]].device
    if tops is None:
        tops = torch.randint(0, h - img_size + 1, (n,), generator=generator, device=dev)
    if lefts is None:
        lefts = torch.randint(0, w - img_size + 1, (n,), generator=generator, device=dev)
    ar = torch.arange(img_size, device=dev)
    rows = (tops.to(dev)[:, None] + ar)[:, :, None]
    cols = (lefts.to(dev)[:, None] + ar)[:, None, :]
    batch = torch.arange(n, device=dev)[:, None, None]
    out = dict(imgs_dict)
    for k in keys:
        out[k] = imgs_dict[k][batch, rows, cols]
    return out


def zero_nan_inputs(imgs_dict: Mapping[str, torch.Tensor]) -> dict:
    """NaN/inf -> 0 for the continuous pixel modalities (fcmae.py:445-449);
    they double as targets, so their losses see the zeroed values too."""
    return {k: torch.nan_to_num(v, nan=0.0, posinf=0.0, neginf=0.0)
            if k in M.CONTINUOUS_PIXEL_MODALITIES else v for k, v in imgs_dict.items()}


class _LossFn(nn.Module):
    """Holds the uncertainty weights under upstream's ``loss_fn.log_vars`` key."""

    def __init__(self, n_tasks: int):
        super().__init__()
        self.log_vars = nn.Parameter(torch.zeros(n_tasks))


class FCMAE(nn.Module):
    def __init__(self, img_size: int = 112, patch_size: int = 16, depths=(3, 3, 9, 3),
                 dims=(96, 192, 384, 768), decoder_depth: int = 1,
                 decoder_embed_dim: int = 512, mask_ratio: float = 0.6,
                 norm_pix_loss: bool = False, grn_group: int = 0, block_impl: str = "auto",
                 sparse_impl: str = "gathered", loss_aggr: str = "uncertainty",
                 loss_full: bool = False, inp_modalities=None, out_modalities=None,
                 dtype=torch.float32, sparse: bool = True, use_orig_stem: bool = False,
                 gelu_approx: bool = False, stem_gathered: bool = False):
        super().__init__()
        inp_modalities = dict(inp_modalities or M.INP_MODALITIES)
        out_modalities = dict(out_modalities or M.OUT_MODALITIES)
        self.img_size, self.patch_size, self.mask_ratio = img_size, patch_size, mask_ratio
        self.norm_pix_loss, self.loss_full, self.loss_aggr = norm_pix_loss, loss_full, loss_aggr
        self.out_modalities = list(out_modalities)
        self.out_chans = M.out_channels(out_modalities)
        self.dtype = dtype
        d = decoder_embed_dim
        self.encoder = ConvNeXtV2(patch_size, img_size,
                                  len(M.resolve_bands(inp_modalities)["sentinel2"]),
                                  depths, dims, grn_group, block_impl, sparse_impl, dtype,
                                  sparse=sparse, use_orig_stem=use_orig_stem,
                                  gelu_approx=gelu_approx, stem_gathered=stem_gathered)
        self.proj = nn.Conv2d(dims[-1], d, 1)
        self.mask_token = nn.Parameter(torch.zeros(1, d, 1, 1))
        decoder = nn.Sequential(*[Block(d, sparse=False, dw_init="trunc1", pw_init="normal02",
                                        dtype=dtype, gelu_approx=gelu_approx)
                                  for _ in range(decoder_depth)])
        self.decoder_dict = nn.ModuleDict({name: decoder for name in self.out_modalities})
        self.pred_dict = nn.ModuleDict({
            name: nn.Conv2d(d, patch_size ** 2 * self.out_chans[name], 1)
            if name in PIXEL_HEAD_MODALITIES else nn.Linear(d, self.out_chans[name])
            for name in self.out_modalities})
        if any(name not in PIXEL_HEAD_MODALITIES for name in self.out_modalities):
            self.layer_norm_tmp = LayerNorm(d, dtype=dtype)
        if loss_aggr == "uncertainty":
            self.loss_fn = _LossFn(len(self.out_modalities))
        self.process_group = None
        self.model_group = None

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def num_visible(self) -> int:
        return int(self.num_patches * (1 - self.mask_ratio))

    def init_weights(self, generator: torch.Generator) -> "FCMAE":
        """The JAX package's init rules (fcmae.py:174-211), drawn from ``generator``."""
        self.encoder.init_weights(generator)
        init_param(self.proj.weight, "trunc1", generator)
        init_param(self.mask_token, "normal02", generator)
        for blk in self.decoder_dict[self.out_modalities[0]]:
            for name, prm in blk.named_parameters():
                if name in blk.inits:
                    init_param(prm, blk.inits[name], generator)
        for name, head in self.pred_dict.items():
            init_param(head.weight, "trunc1" if name in PIXEL_HEAD_MODALITIES else "normal02",
                       generator)
        for name, prm in self.named_parameters():
            if name.endswith(".bias") and not name.startswith("encoder."):
                init_param(prm, "zeros", generator)
        return self

    def forward_decoder(self, x, mask):
        """x: (N, g, g, dims[-1]) stage-4 map; mask: (N, L)."""
        dt, group = self.dtype, self.model_group
        x = column_dense(x, self.proj.weight.flatten(1), self.proj.bias, dt,
                         self.proj.out_channels, group)
        n, h, w, d = x.shape
        m = mask.reshape(n, h, w, 1).to(x.dtype)
        x = x * (1.0 - m) + self.mask_token.reshape(1, 1, 1, d).to(dt) * m
        for blk in self.decoder_dict[self.out_modalities[0]]:
            x = blk(x)
        preds, pooled = {}, None
        for name in self.out_modalities:
            head = self.pred_dict[name]
            if name in PIXEL_HEAD_MODALITIES:
                p = column_dense(x, head.weight.flatten(1), head.bias, dt, head.out_channels,
                                 group)
                preds[name] = p.reshape(n, h * w, p.shape[-1])
            else:
                if pooled is None:
                    pooled = self.layer_norm_tmp(x).mean((1, 2))
                preds[name] = column_dense(pooled, head.weight, head.bias, dt, head.out_features,
                                           group)
        return preds

    def forward_loss(self, targets, preds, mask):
        loss_dict = multipretext_loss(preds, targets, mask, patch_size=self.patch_size,
                                      out_chans=self.out_chans,
                                      norm_pix_loss=self.norm_pix_loss, loss_full=self.loss_full,
                                      process_group=self.process_group)
        if self.loss_aggr == "uncertainty":
            loss, weighted = uncertainty_weighted(loss_dict, self.loss_fn.log_vars)
            return loss, loss_dict, self.loss_fn.log_vars, weighted
        loss, weighted = unweighted(loss_dict)
        return loss, loss_dict, None, weighted

    def forward(self, imgs_dict: Mapping[str, torch.Tensor], mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None):
        """imgs_dict: the cropped, NaN-zeroed NHWC modality dict.  ``mask``
        (N, L), 1 = removed; when None it is made from ``noise`` (N, L), or
        from noise drawn from ``generator`` (:func:`gen_random_mask`), and
        keeps ``num_visible`` patches in every row by construction.  A given
        mask is checked on the host: one that keeps ``num_visible`` patches
        in every row runs the configured ``sparse_impl``; any other runs the
        masked-dense encoder.  A captured step passes ``noise``, so no host
        read is needed.  Returns (loss, preds, mask, loss_dict, log_vars,
        weighted_losses)."""
        imgs = imgs_dict["sentinel2"].to(self.dtype)
        k = self.num_visible
        if mask is None:
            if noise is None:
                noise = torch.randn(imgs.shape[0], self.num_patches, generator=generator,
                                    device=imgs.device)
            mask = mask_from_noise(noise, self.mask_ratio)
        elif not bool(((mask == 0).sum(1) == k).all()):
            k = None
        x = self.encoder.encode(imgs, mask, k)
        preds = self.forward_decoder(x, mask)
        loss, loss_dict, log_vars, weighted = self.forward_loss(imgs_dict, preds, mask)
        return loss, preds, mask, loss_dict, log_vars, weighted

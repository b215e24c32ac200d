"""The plain FCMAE pretraining step that the benchmark holds the port to.

Plain PyTorch in float32, written from the MP-MAE description (the sparse
ConvNeXtV2 encoder of FCMAE, one shared decoder Block, a head per output
modality, the uncertainty-weighted multi-pretext loss) and nothing else:
no kernel, no cache, no batching trick.  It imports nothing of the program.

The encoder's sparse convolution keeps the MinkowskiEngine semantics: a
masked patch does not exist, so every op after the stem sees the visible
patches only.  Here that is spelled out on "rows": the visible patches of
each sample, ``(N, K, p, p, C)``, in ascending patch order.  A depthwise 7x7
convolution places the rows on the dense grid with zeros elsewhere, convolves
and reads the visible sites back; a 2x2 stride-2 downsample is a product over
each 2x2 window of a patch.
Global Response Normalization on the rows takes one statistic over every
visible site of the batch (the per-device scope of one device).

Params are a dict keyed by the program's parameter names, so one set of
tensors serves both.  ``dtype`` is the precision of every product and of
the activations between ops: float32 for the reference, lower for a control
(:mod:`.precision`).
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .precision import Precision

# the modalities whose head predicts pixels (a 1x1 conv to p*p*C)
PIXEL_HEADS = ("sentinel2", "sentinel1", "aster", "canopy_height_eth",
               "dynamic_world", "esa_worldcover", "IMNET")
PIXEL_WISE = ("sentinel2", "sentinel1", "aster", "canopy_height_eth",
              "esa_worldcover", "dynamic_world")
CONTINUOUS_PIXEL = ("sentinel2", "sentinel1", "aster", "canopy_height_eth")
CATEGORICAL_PIXEL = ("dynamic_world", "esa_worldcover")
IMAGE_CATEGORICAL = ("biome", "eco_region")
IMAGE_LEVEL = ("biome", "eco_region", "lat", "lon", "month", "era5")
KS = 7


class Shape:
    """The sizes of one FCMAE configuration (a config file's ``model``)."""

    def __init__(self, cfg: Mapping):
        self.img = int(cfg["img_size"])
        self.patch = int(cfg["patch_size"])
        self.depths = tuple(cfg["depths"])
        self.dims = tuple(cfg["dims"])
        self.decoder_dim = int(cfg["decoder_embed_dim"])
        self.decoder_depth = int(cfg["decoder_depth"])
        self.mask_ratio = float(cfg["mask_ratio"])
        self.in_chans = int(cfg["in_chans"])
        self.out_chans = dict(cfg["out_chans"])
        self.grid = self.img // self.patch
        self.stem_stride = self.patch // 2 ** (len(self.depths) - 1)

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def num_visible(self) -> int:
        return int(self.num_patches * (1 - self.mask_ratio))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def layer_norm(x, w, b, eps: float = 1e-6):
    """Over the last (channel) axis, biased variance."""
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def linear(x, w, b, pr: Precision):
    return pr.act(F.linear(pr.op(x), pr.op(w), b))


def safe_sqrt(s):
    """sqrt with a zero gradient where ``s`` is 0 (a dead channel)."""
    pos = s > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, s, torch.ones_like(s))),
                       torch.zeros_like(s))


class DWConv7(torch.autograd.Function):
    """Depthwise 7x7 SAME convolution of an NCHW map with a bias.  The
    input gradient is the flipped-tap convolution; the tap gradient is the
    49 shifted products summed, as the definition reads."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, b, padding=KS // 2, groups=x.shape[1])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        c, h, wd = x.shape[1], x.shape[2], x.shape[3]
        dx = F.conv2d(dy, w.flip(2, 3), padding=KS // 2, groups=c)
        xp = F.pad(x, (3, 3, 3, 3))
        dw = torch.stack([(xp[:, :, a:a + h, e:e + wd] * dy).sum((0, 2, 3))
                          for a in range(KS) for e in range(KS)], dim=1)
        return dx, dw.reshape(c, 1, KS, KS), dy.sum((0, 2, 3))


def dwconv7(x_nhwc, w, b, pr: Precision):
    y = DWConv7.apply(pr.op(x_nhwc).permute(0, 3, 1, 2), pr.op(w), b)
    return pr.act(y.permute(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# the visible rows of a sample
# ---------------------------------------------------------------------------
def to_rows(dense, kept, grid: int):
    """(N, H, W, C) -> (N, K, p, p, C): the ``kept`` (N, K) patches."""
    n, h, _, c = dense.shape
    p = h // grid
    patches = dense.reshape(n, grid, p, grid, p, c).permute(0, 1, 3, 2, 4, 5)
    patches = patches.reshape(n, grid * grid, p, p, c)
    return patches[torch.arange(n, device=dense.device)[:, None], kept]


def to_dense(rows, kept, grid: int):
    """(N, K, p, p, C) -> (N, H, W, C), zeros at the patches not kept."""
    n, _, p, _, c = rows.shape
    patches = rows.new_zeros(n, grid * grid, p, p, c)
    patches = patches.index_put((torch.arange(n, device=rows.device)[:, None], kept), rows)
    dense = patches.reshape(n, grid, grid, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return dense.reshape(n, grid * p, grid * p, c)


def upsample(keep, grid: int, size: int):
    """(N, L) patch map -> (N, size, size, 1), nearest."""
    n, s = keep.shape[0], size // grid
    m = keep.reshape(n, grid, 1, grid, 1, 1).expand(n, grid, s, grid, s, 1)
    return m.reshape(n, size, size, 1)


def mask_from_noise(noise, mask_ratio: float):
    """(N, L) mask, 1 = removed: the ``int(L * (1 - ratio))`` patches of
    lowest noise in each row are kept (MAE's noise and double argsort)."""
    n, num = noise.shape
    keep_n = int(num * (1 - mask_ratio))
    rank = torch.argsort(torch.argsort(noise, dim=1), dim=1)
    return (rank >= keep_n).float()


def kept_patches(mask, num_visible: int):
    """(N, K) ids of the visible patches, ascending."""
    ids = torch.arange(mask.shape[1], device=mask.device).expand_as(mask)
    key = mask * mask.shape[1] + ids  # visible first, each group ascending
    return torch.sort(key, dim=1).indices[:, :num_visible]


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------
def block_tail(t, prm, pre: str, pr: Precision, rows_axes, eps: float):
    """LN -> Linear -> GELU -> GRN -> Linear on ``t``; the GRN statistic is
    the L2 over ``rows_axes`` (every visible site of the batch on the
    encoder's rows, eps 1e-6; each sample's sites in the dense decoder,
    eps 1e-4)."""
    u = gelu(linear(layer_norm(t, prm[pre + "norm.weight"], prm[pre + "norm.bias"]),
                    prm[pre + "pwconv1.weight"], prm[pre + "pwconv1.bias"], pr))
    c4 = u.shape[-1]
    gx = safe_sqrt(u.square().sum(rows_axes, keepdim=True))
    nx = gx / (gx.mean(-1, keepdim=True) + eps)
    u = pr.act(prm[pre + "grn.gamma"].reshape(c4) * (u * nx) + prm[pre + "grn.beta"].reshape(c4)
               + u)
    return linear(u, prm[pre + "pwconv2.weight"], prm[pre + "pwconv2.bias"], pr)


def remat(fn, remat_on: bool, *args):
    """``fn(*args)``, its activations recomputed in the backward where
    ``remat_on`` (the same function, in less memory)."""
    return checkpoint(fn, *args, use_reentrant=False) if remat_on else fn(*args)


def stem(x, keep, prm, s: Shape, pr: Precision):
    """initial 3x3 conv -> LN -> GELU -> depthwise s x s stride-s conv ->
    LN, re-masked, on the dense grid."""
    grid, st = s.grid, s.stem_stride
    h = s.img // st
    keep_px = upsample(keep, grid, s.img)
    x = x * keep_px
    e = "encoder."
    y = F.conv2d(pr.op(x).permute(0, 3, 1, 2), pr.op(prm[e + "initial_conv.0.weight"]),
                 prm[e + "initial_conv.0.bias"], padding=1)
    y = layer_norm(pr.act(y.permute(0, 2, 3, 1)), prm[e + "initial_conv.1.weight"],
                   prm[e + "initial_conv.1.bias"])
    y = gelu(y * keep_px)
    y = F.conv2d(pr.op(y).permute(0, 3, 1, 2), pr.op(prm[e + "stem.0.weight"]),
                 prm[e + "stem.0.bias"], stride=st, groups=y.shape[-1])
    y = layer_norm(pr.act(y.permute(0, 2, 3, 1)), prm[e + "stem.1.weight"], prm[e + "stem.1.bias"])
    return y * upsample(keep, grid, h)


def encoder_block(rows, kept, prm, b: str, s: Shape, pr: Precision):
    t = to_rows(dwconv7(to_dense(rows, kept, s.grid), prm[b + "dwconv.weight"],
                        prm[b + "dwconv.bias"], pr), kept, s.grid)
    return rows + block_tail(t, prm, b, pr, (0, 1, 2, 3), 1e-6)


def encoder(x, mask, prm, s: Shape, pr: Precision, remat_on: bool = False):
    """The sparse encoder: (N, H, W, in) and the (N, L) mask -> the dense
    (N, g, g, C4) stage-4 map, zero at the masked patches.  ``remat_on``
    recomputes the stem's and each Block's activations in the backward."""
    e, grid = "encoder.", s.grid
    y = remat(lambda x_: stem(x_, 1.0 - mask, prm, s, pr), remat_on, x)
    kept = kept_patches(mask, s.num_visible)
    rows = to_rows(y, kept, grid)
    for i, depth in enumerate(s.depths):
        if i:
            d = f"{e}downsample_layers.{i - 1}."
            rows = layer_norm(rows, prm[d + "0.weight"], prm[d + "0.bias"])
            # the 2x2 stride-2 conv: a product over each 2x2 window of a patch
            n, k, p, _, c = rows.shape
            q = p // 2
            win = rows.reshape(n, k, q, 2, q, 2, c).permute(0, 1, 2, 4, 3, 5, 6)
            w = prm[d + "1.weight"]
            rows = linear(win.reshape(n, k, q, q, 4 * c), w.permute(0, 2, 3, 1).flatten(1),
                          prm[d + "1.bias"], pr)
        for j in range(depth):
            b = f"{e}stages.{i}.{j}."
            rows = remat(lambda r, b=b: encoder_block(r, kept, prm, b, s, pr), remat_on, rows)
    return to_dense(rows, kept, grid)


def decoder(x, mask, prm, s: Shape, pr: Precision, out_modalities):
    """proj -> mask token -> the shared Blocks -> each modality's head."""
    n, g = x.shape[0], s.grid
    x = linear(x, prm["proj.weight"].flatten(1), prm["proj.bias"], pr)
    m = mask.reshape(n, g, g, 1)
    x = x * (1.0 - m) + prm["mask_token"].reshape(1, 1, 1, -1) * m
    first = out_modalities[0]
    for j in range(s.decoder_depth):
        b = f"decoder_dict.{first}.{j}."
        t = dwconv7(x, prm[b + "dwconv.weight"], prm[b + "dwconv.bias"], pr)
        x = x + block_tail(t, prm, b, pr, (1, 2), 1e-4)
    preds, pooled = {}, None
    for name in out_modalities:
        w, bias = prm[f"pred_dict.{name}.weight"], prm[f"pred_dict.{name}.bias"]
        if name in PIXEL_HEADS:
            p = linear(x, w.flatten(1), bias, pr)
            preds[name] = p.reshape(n, g * g, p.shape[-1])
        else:
            if pooled is None:
                pooled = layer_norm(x, prm["layer_norm_tmp.weight"],
                                    prm["layer_norm_tmp.bias"]).mean((1, 2))
            preds[name] = linear(pooled, w, bias, pr)
    return preds


# ---------------------------------------------------------------------------
# the multi-pretext loss
# ---------------------------------------------------------------------------
def patchify(imgs, p: int):
    n, h, w, c = imgs.shape
    x = imgs.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (h // p) * (w // p), p * p * c)


def cross_entropy(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    safe = labels.long().clamp(0, logits.shape[-1] - 1)
    return lse - torch.gather(logits, -1, safe[..., None])[..., 0]


def ratio(num, den):
    return torch.where(den > 0, num / den.clamp(min=1.0), torch.zeros_like(num))


def modality_loss(name, pred, target, mask, p: int, chans: int):
    """The loss of one modality as (numerator, denominator)."""
    pred = pred.float()
    if name in IMAGE_CATEGORICAL:
        return cross_entropy(pred, target.argmax(-1)).sum(), torch.tensor(
            float(pred.shape[0]), device=pred.device)
    if name in IMAGE_LEVEL:
        t = target.float()
        valid = ~torch.isnan(t)
        sq = (pred - torch.where(valid, t, torch.zeros_like(t))).square()
        return torch.where(valid, sq, torch.zeros_like(sq)).sum(), valid.float().sum()
    n, l, _ = pred.shape
    if name in CATEGORICAL_PIXEL:
        labels = patchify(target.long(), p).reshape(n, l, p * p)
        ce = cross_entropy(pred.reshape(n, l, p * p, chans), labels)
        valid = (mask[:, :, None] == 1) & (labels != -1)
        return torch.where(valid, ce, torch.zeros_like(ce)).sum(), valid.float().sum()
    sq = (pred - patchify(target.float(), p)).square()
    valid = ~torch.isnan(sq)
    count = valid.sum(-1)
    per_patch = torch.where(valid, sq, torch.zeros_like(sq)).sum(-1) / count.clamp(min=1)
    per_patch = torch.where(count > 0, per_patch, torch.full_like(per_patch, float("nan")))
    tmp = per_patch * mask
    tmp = torch.where(torch.isnan(tmp), torch.zeros_like(tmp), tmp)
    return tmp.sum(), (tmp != 0.0).float().sum()


def crop(batch, tops, lefts, size: int):
    """The same per-sample window of every pixel-wise modality."""
    out = dict(batch)
    n = tops.shape[0]
    ar = torch.arange(size, device=tops.device)
    rows = (tops[:, None] + ar)[:, :, None]
    cols = (lefts[:, None] + ar)[:, None, :]
    idx = torch.arange(n, device=tops.device)[:, None, None]
    for k in PIXEL_WISE:
        if k in batch and batch[k].ndim == 4 and batch[k].shape[1] > size:
            out[k] = batch[k][idx, rows, cols]
    return out


def loss(prm, batch, tops, lefts, noise, s: Shape, pr: Precision, rows=None,
         remat_on: bool = False):
    """The step's uncertainty-weighted loss and each modality's raw loss.
    ``rows`` (a slice) keeps only those samples: the fault of a step that
    leaves part of its batch out.  ``remat_on``: see :func:`encoder`."""
    batch = crop(batch, tops, lefts, s.img) if tops is not None else dict(batch)
    if rows is not None:
        batch = {k: v[rows] for k, v in batch.items()}
        noise = noise[rows]
    for k in CONTINUOUS_PIXEL:
        if k in batch:
            batch[k] = torch.nan_to_num(batch[k].float(), nan=0.0, posinf=0.0, neginf=0.0)
    mask = mask_from_noise(noise, s.mask_ratio)
    outs = list(s.out_chans)
    x = encoder(pr.act(batch["sentinel2"].float()), mask, prm, s, pr, remat_on)
    preds = decoder(x, mask, prm, s, pr, outs)
    parts = [modality_loss(k, preds[k], batch[k], mask, s.patch, s.out_chans[k]) for k in outs]
    raw = torch.stack([ratio(num, den) for num, den in parts])
    log_vars = prm["loss_fn.log_vars"]
    weighted = (torch.exp(-log_vars) * raw + log_vars) * (raw != 0.0)
    return weighted.sum(), raw

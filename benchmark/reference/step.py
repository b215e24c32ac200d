"""The reference's training steps: its own draws, the loss of
:mod:`.model`, autograd, and AdamW, all in float32 (TF32 off).

The draws of step ``i`` come from a generator seeded with
``(seed * 1_000_003 + i) mod 2**63`` on the batch's device: the crop's tops,
then its lefts (each ``randint(0, tile - img + 1, (N,))``), then the mask's
noise (``randn(N, L)``), in that order.  That is the program's documented
scheme (``fold_in``), written out again here.
"""
from __future__ import annotations

from typing import Mapping

import torch

from .model import Shape, loss
from .precision import F32, Precision


def step_generator(seed: int, step: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + step) % (2 ** 63))


def draws(seed: int, step: int, n: int, tile: int, s: Shape, device):
    """(tops, lefts, noise) of one step; no crop where the tile is the image."""
    g = step_generator(seed, step, device)
    tops = lefts = None
    if tile > s.img:
        tops = torch.randint(0, tile - s.img + 1, (n,), generator=g, device=device)
        lefts = torch.randint(0, tile - s.img + 1, (n,), generator=g, device=device)
    noise = torch.randn(n, s.num_patches, generator=g, device=device)
    return tops, lefts, noise


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class AdamW:
    """Adam's moments with bias correction, then decoupled weight decay on
    the params of more than one dim, all times the lr (the MAE recipe's
    ``param_groups_weight_decay``)."""

    def __init__(self, params: Mapping[str, torch.Tensor], lr: float, weight_decay: float,
                 betas, eps: float = 1e-8):
        self.params = params
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, tuple(betas), eps
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k].mul_(b1).add_(g, alpha=1 - b1)
            self.nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (self.mu[k] / c1) / ((self.nu[k] / c2).sqrt() + self.eps)
            if p.ndim > 1:
                upd = upd + self.wd * p
            p.sub_(self.lr * upd)


def train(params: Mapping[str, torch.Tensor], batches, seed: int, tile: int, s: Shape,
          optim: Mapping, pr: Precision = F32, rows=None, keep_state: bool = False):
    """Run ``len(batches)`` steps from ``params`` (copied, in float32) on
    ``batches`` (one dict of device tensors a step).  Returns the losses,
    the first step's gradient, the params after the last step and AdamW's
    first moment after it.  The encoder's activations are recomputed in
    the backward, so that a full-size batch fits.  ``rows`` keeps only those samples of every
    batch (a fault); ``keep_state``: the steps leave the params as they
    were (a fault)."""
    prm = {k: v.detach().float().clone().requires_grad_(True) for k, v in params.items()}
    opt = AdamW(prm, optim["lr"], optim["weight_decay"], optim["betas"])
    losses, first_grad = [], None
    for i, batch in enumerate(batches):
        n = batch["sentinel2"].shape[0]
        tops, lefts, noise = draws(seed, i, n, tile, s, batch["sentinel2"].device)
        total, _ = loss(prm, batch, tops, lefts, noise, s, pr, rows, remat_on=True)
        grads = torch.autograd.grad(total, list(prm.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(prm.items(), grads)}
        losses.append(float(total.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        if not keep_state:
            opt.step(grads)
        del total, grads
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: v.detach() for k, v in prm.items()}, "mu": opt.mu}

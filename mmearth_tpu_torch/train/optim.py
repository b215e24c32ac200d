"""Pretraining optimizer (port of the pretrain side of ``mmearth_tpu/train/optim.py``).

AdamW in the order of the optax chain the JAX package builds
(``optim.py:230-251``): optional clip of the raw gradients by global norm,
Adam moments with bias correction, decoupled weight decay on the masked
params, then the learning rate of the schedule at the update count.  With
``update_freq = k`` the gradients of k micro-steps are averaged (a running
mean, as ``optax.MultiSteps``) and the update is applied on the k-th.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


def pretrain_wd_mask(named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """Decay iff the param has more than one dim (timm
    param_groups_weight_decay).  With upstream's shapes that decays the
    (1, 1, 1, C) GRN affines and the (1, D, 1, 1) mask token, and no bias,
    LayerNorm param or log_vars."""
    return {name: p.ndim > 1 for name, p in named_params}


class AdamW:
    def __init__(self, named_params, lr_schedule: Callable[[int], float],
                 weight_decay: float = 0.05, betas: tuple[float, float] = (0.9, 0.95),
                 eps: float = 1e-8, update_freq: int = 1, clip_grad: float | None = None):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        decay = pretrain_wd_mask(named)
        self.params = [p for _, p in named]
        self.decay = [decay[n] for n, _ in named]
        self.lr_schedule = lr_schedule
        self.weight_decay, self.betas, self.eps = weight_decay, betas, eps
        self.update_freq, self.clip_grad = update_freq, clip_grad
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if update_freq > 1 else None
        self.count = 0  # applied updates
        self.mini_step = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _grads(self) -> list[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> bool:
        """Consume the current ``.grad``s; returns True when params changed."""
        grads = self._grads()
        if self.acc is not None:
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.update_freq:
                return False
            self.mini_step = 0
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.clip_grad is not None:
            norm = global_norm(grads)
            scale = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                self.clip_grad / norm)
            torch._foreach_mul_(grads, scale)
        b1, b2 = self.betas
        lr = self.lr_schedule(self.count)
        self.count += 1
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        mu_hat = torch._foreach_div(self.mu, 1 - b1 ** self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1 - b2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        dec = [i for i, d in enumerate(self.decay) if d]
        if dec and self.weight_decay:
            torch._foreach_add_([upd[i] for i in dec], [self.params[i] for i in dec],
                                alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        return True


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))

"""AdamW for pretraining and finetuning (port of ``mmearth_tpu/train/optim.py``).

AdamW in the order of the optax chains the JAX package builds
(``optim.py:230-251,254-306``): optional clip of the raw gradients by global
norm, Adam moments with bias correction, decoupled weight decay on the
masked params, the learning rate of the schedule at the update count, then
each param's layer-decay lr scale, which multiplies the whole update (Adam
step and decay alike).  With ``update_freq = k`` the gradients of k
micro-steps are averaged (a running mean, as ``optax.MultiSteps``) and the
update is applied on the k-th.  Frozen params (``requires_grad`` off, the
linear probe's trunk) are left out: no update and no decay, as JAX's
``mask_updates`` with the decay mask cut by the trainable mask.
"""
from __future__ import annotations

from typing import Callable, Iterable, Mapping, Sequence

import torch


def pretrain_wd_mask(named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """Decay iff the param has more than one dim (timm
    param_groups_weight_decay).  With upstream's shapes that decays the
    (1, 1, 1, C) GRN affines and the (1, D, 1, 1) mask token, and no bias,
    LayerNorm param or log_vars."""
    return {name: p.ndim > 1 for name, p in named_params}


def finetune_wd_mask(named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """No decay for 1-dim params, biases and the GRN gamma/beta, which are
    (1, 1, 1, C) here and so are excluded by name (optim.py:48-58,
    optim_factory.py:108-119)."""
    return {name: not (p.ndim <= 1 or name.endswith(("bias", "gamma", "beta")))
            for name, p in named_params}


def _stage_block(name: str) -> tuple[str, int, int]:
    """(kind, i, j) of a param name in upstream's layout: ``stages.i.j.*``,
    ``downsample_layers.i.*``, or "other" (the stem modules ``initial_conv``
    and ``stem``, ``norm``, ``head``), as JAX ``_parse_stage_block``
    (optim.py:64-86).  The stem matches neither prefix of the reference's
    layer-id functions and so takes the top layer id, as the head does."""
    parts = name.split(".")
    if parts[0] == "encoder":
        parts = parts[1:]
    if parts[0] == "stages":
        return "stages", int(parts[1]), int(parts[2])
    if parts[0] == "downsample_layers":
        return "downsample_layers", int(parts[1]), 0
    return "other", -1, -1


def layer_id_single(name: str, depths: Sequence[int]) -> int:
    """optim_factory.get_num_layer_for_convnext_single (JAX optim.py:89-96)."""
    kind, i, j = _stage_block(name)
    if kind == "downsample_layers":
        return sum(depths[:i]) + 1
    if kind == "stages":
        return sum(depths[:i]) + j + 1
    return sum(depths) + 1


def layer_id_group(name: str) -> int:
    """optim_factory.get_num_layer_for_convnext, the 12-group scheme (JAX
    optim.py:99-110)."""
    kind, i, j = _stage_block(name)
    if kind == "downsample_layers":
        return {0: 0, 1: 2, 2: 3, 3: 12}[i]
    if kind == "stages":
        if i in (0, 1):
            return i + 1
        if i == 2:
            return 3 + j // 3
        return 12
    return 13


def layer_lr_scales(named_params: Iterable[tuple[str, torch.Tensor]], layer_decay: float,
                    depths: Sequence[int], kind: str = "single") -> dict[str, float]:
    """Per-param lr multipliers: decay ** (num_layers + 1 - layer_id)
    (main_finetune.py:530-544, JAX optim.py:113-122)."""
    num_layers = 12 if kind == "group" else sum(depths)

    def lid(name: str) -> int:
        return layer_id_group(name) if kind == "group" else layer_id_single(name, depths)

    return {name: layer_decay ** (num_layers + 1 - lid(name)) for name, _ in named_params}


class AdamW:
    """``wd_mask`` (name -> decay?) defaults to :func:`pretrain_wd_mask`;
    ``lr_scales`` (name -> factor), when given, scales each param's update."""

    def __init__(self, named_params, lr_schedule: Callable[[int], float],
                 weight_decay: float = 0.05, betas: tuple[float, float] = (0.9, 0.95),
                 eps: float = 1e-8, update_freq: int = 1, clip_grad: float | None = None,
                 wd_mask: Mapping[str, bool] | None = None,
                 lr_scales: Mapping[str, float] | None = None):
        named = [(n, p) for n, p in named_params if p.requires_grad]
        decay = pretrain_wd_mask(named) if wd_mask is None else wd_mask
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.decay = [decay[n] for n, _ in named]
        self.scales = None if lr_scales is None else [lr_scales[n] for n, _ in named]
        self.lr_schedule = lr_schedule
        self.weight_decay, self.betas, self.eps = weight_decay, betas, eps
        self.update_freq, self.clip_grad = update_freq, clip_grad
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] if update_freq > 1 else None
        self.count = 0  # applied updates
        self.mini_step = 0

    def state_dict(self) -> dict:
        """The moments (and the accumulated gradient mean under
        ``update_freq`` > 1) keyed by param name, the update count and the
        micro-step within the accumulation: tensors and ints only."""
        per_name = lambda ts: None if ts is None else dict(zip(self.names, ts))
        return {"mu": per_name(self.mu), "nu": per_name(self.nu), "acc": per_name(self.acc),
                "count": self.count, "mini_step": self.mini_step}

    def load_state_dict(self, state: Mapping) -> None:
        """Copy ``state`` (from :meth:`state_dict`, on any device) into this
        optimizer's tensors, which stay on their params' device."""
        for key, mine in (("mu", self.mu), ("nu", self.nu), ("acc", self.acc)):
            theirs = state[key]
            if (mine is None) != (theirs is None) or (
                    mine is not None and set(theirs) != set(self.names)):
                raise ValueError(f"optimizer state {key!r} does not match the params "
                                 f"(update_freq {self.update_freq})")
            for name, t in zip(self.names, mine or ()):
                t.copy_(theirs[name])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])

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
        if self.scales is not None:
            torch._foreach_mul_(upd, self.scales)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        return True


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))

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

The schedule and the accumulation's branch stay on the host, a function of
the update count and the micro-step (:meth:`AdamW.plan`); the lr and the
bias corrections reach the update as a device tensor that the host writes
before each step, so a CUDA graph of steps reads them anew on every replay,
and the eager and the captured step run the same tensor arithmetic.
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
        # lr, 1 - b1^t and 1 - b2^t of the next update, written by the host
        # before each step (device tensors, so a captured step reads them anew)
        self.hyper = torch.zeros(3, dtype=torch.float32,
                                 device=self.params[0].device if self.params else None)

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

    def plan(self, n: int) -> list[tuple[int, bool, list[float]]]:
        """The next ``n`` steps from the host's state, which does not change:
        each step's micro-step within the accumulation, whether it applies
        an update, and that update's lr (the schedule at the update count)
        and bias corrections ``1 - b1^t``, ``1 - b2^t`` (zeros where it
        applies none)."""
        b1, b2 = self.betas
        period = self.update_freq if self.acc is not None else 1
        mini, count, out = self.mini_step, self.count, []
        for _ in range(n):
            applies = mini + 1 == period
            out.append((mini, applies, [self.lr_schedule(count), 1 - b1 ** (count + 1),
                                        1 - b2 ** (count + 1)] if applies else [0.0] * 3))
            mini, count = (mini + 1) % period, count + applies
        return out

    def advance(self, applies: bool) -> None:
        """The host's count after one step (see :meth:`plan`)."""
        if self.acc is not None:
            self.mini_step = (self.mini_step + 1) % self.update_freq
        self.count += applies

    @torch.no_grad()
    def step(self) -> bool:
        """Consume the current ``.grad``s; returns True when params changed."""
        ((mini, applies, hyper),) = self.plan(1)
        if applies:
            write_host_values(self.hyper, hyper)
        self.update(self.hyper, mini, applies)
        self.advance(applies)
        return applies

    @torch.no_grad()
    def update(self, hyper: torch.Tensor, mini: int, applies: bool) -> None:
        """The tensor work of one step, with no host synchronisation: fold the
        ``.grad``s into the running mean as micro-step ``mini``, and where
        ``applies``, the update with ``hyper``'s lr and bias corrections.
        :meth:`step` runs it eagerly; ``train/step.py::ChainedStep`` captures
        it with each step's micro-step, kind and ``hyper`` row."""
        grads = self._grads()
        if self.acc is not None:
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (mini + 1))
            if not applies:
                return
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        if self.clip_grad is not None:
            norm = global_norm(grads)
            scale = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                self.clip_grad / norm)
            torch._foreach_mul_(grads, scale)
        b1, b2 = self.betas
        lr, bc1, bc2 = hyper[0], hyper[1], hyper[2]
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        mu_hat = torch._foreach_div(self.mu, bc1)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        dec = [i for i, d in enumerate(self.decay) if d]
        if dec and self.weight_decay:
            torch._foreach_add_([upd[i] for i in dec], [self.params[i] for i in dec],
                                alpha=self.weight_decay)
        if self.scales is not None:
            torch._foreach_mul_(upd, self.scales)
        torch._foreach_mul_(upd, lr)
        torch._foreach_sub_(self.params, upd)


def write_host_values(dst: torch.Tensor, values) -> None:
    """``dst`` = ``values`` (host numbers) without waiting for the device: on
    a card through pinned memory, copied in stream order (the pinned block is
    not reused before the copy has run)."""
    src = torch.tensor(values, dtype=dst.dtype)
    if dst.is_cuda:
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))

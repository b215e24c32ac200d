"""The optimizers of pretraining and finetuning (port of
``mmearth_tpu/train/optim.py``): AdamW, and for finetuning every ``--opt``
family of the reference (:data:`FAMILIES`) with optax's semantics.

Each in the order of the optax chains the JAX package builds
(``optim.py:171-306``): optional clip of the raw gradients by global norm,
the family's scaling (AdamW: Adam moments with bias correction, then
decoupled weight decay on the masked params; the other families decay as
:meth:`Optimizer.update` says), the learning rate of the schedule at the
update count, then each param's layer-decay lr scale, which multiplies the
whole update (step and decay alike).  With ``update_freq = k`` the gradients of k
micro-steps are averaged (a running mean, as ``optax.MultiSteps``) and the
update is applied on the k-th.  Frozen params (``requires_grad`` off, the
linear probe's trunk) are left out: no update and no decay, as JAX's
``mask_updates`` with the decay mask cut by the trainable mask.

The schedule and the accumulation's branch stay on the host, a function of
the update count and the micro-step (:meth:`Optimizer.plan`); the lr and the
family's step-dependent factors reach the update as a device tensor that the host writes
before each step, so a CUDA graph of steps reads them anew on every replay,
and the eager and the captured step run the same tensor arithmetic.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np
import torch

from ..parallel.mesh import all_reduce_grads, as_mesh, sum_


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
    layer-id functions and so takes the top layer id, as the head does.  So
    do the U-Net's decoder (``upsample_layers``, ``initial_conv_upsample``)
    and every ResNet name: torchvision's ``layer1.0...``,
    ``layer2.0.downsample.0...`` and the ResNet-UNet's ``encoder.layer...``
    and ``decoder...`` start with neither prefix, as JAX's ``stage0_1``
    does not."""
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


# the reference's --opt names (optim_factory.py:149-252) -> the family whose
# update they run (JAX optim.py::_opt_scaler); a "fused" prefix (apex) maps
# to the plain family
FAMILIES = {"adamw": "adamw", "adam": "adam", "nadam": "nadam", "radam": "radam",
            "sgd": "sgd", "nesterov": "sgd", "momentum": "momentum", "adadelta": "adadelta",
            "adafactor": "adafactor", "rmsprop": "rmsprop", "rmsproptf": "rmsprop",
            "novograd": "novograd", "nvnovograd": "novograd", "lamb": "lamb"}
# the families whose weight decay enters the gradient before their
# statistics (torch's L2 of every family but AdamW); adamw and lamb decay
# the scaled update, novograd its normalised gradient
COUPLED = ("adam", "nadam", "radam", "sgd", "momentum", "adadelta", "adafactor", "rmsprop")
# each family's state tensors a param
SLOTS = {"adamw": ("mu", "nu"), "adam": ("mu", "nu"), "nadam": ("mu", "nu"),
         "radam": ("mu", "nu"), "lamb": ("mu", "nu"), "sgd": ("trace",),
         "momentum": ("trace",), "adadelta": ("e_g", "e_x"),
         "adafactor": ("v_row", "v_col", "v"), "rmsprop": ("nu", "trace"),
         "novograd": ("mu", "nu")}
RADAM_THRESHOLD = 5.0
ADADELTA_RHO = 0.9
RMSPROP_DECAY = 0.9
ADAFACTOR = {"decay_rate": 0.8, "min_dim_size_to_factor": 128, "epsilon": 1e-30}


def family(opt: str) -> str:
    """The family of an ``--opt`` name; adamp, sgdp, adahessian and unknown
    names raise ``ValueError``, as JAX's ``_opt_scaler`` does."""
    o = opt.lower()
    if o.startswith("fused"):
        o = o[len("fused"):]
    if o not in FAMILIES:
        raise ValueError(f"Optimizer {opt!r} not supported (reference optim_factory.py:252)")
    return FAMILIES[o]


def flax_axes(ndim: int) -> tuple[int, ...]:
    """The port's axes of a param of ``ndim`` dims in the JAX package's
    layout order: a Linear's (out, in) is flax's (in, out), a conv's OIHW
    flax's HWIO."""
    return {2: (1, 0), 4: (2, 3, 1, 0)}.get(ndim, tuple(range(ndim)))


def factored_dims(shape: Sequence[int], min_dim: int = ADAFACTOR["min_dim_size_to_factor"]):
    """optax ``_factored_dims`` of a leaf of the port's ``shape`` (the whole
    leaf's, where a rank holds a shard) in the flax layout, as the port's
    axes: (d1, d0), the second largest and the largest dim (ties broken in
    flax's order), or None where the second is under ``min_dim``."""
    shape = tuple(shape)
    if len(shape) < 2:
        return None
    axes = flax_axes(len(shape))
    order = np.argsort([shape[a] for a in axes])
    if shape[axes[order[-2]]] < min_dim:
        return None
    return axes[order[-2]], axes[order[-1]]


class Optimizer:
    """One optimizer of the reference's ``--opt`` families with optax's
    semantics (JAX ``make_finetune_optimizer``).  ``wd_mask`` (name ->
    decay?) defaults to :func:`pretrain_wd_mask`; ``lr_scales`` (name ->
    factor), when given, scales each param's update; ``momentum`` is sgd's,
    nesterov's, momentum's and rmsprop's trace decay.

    Every family shares the machinery: the gradients of ``update_freq``
    micro-steps averaged, the optional clip by their global norm (over the
    trainable params), the family's update of its state tensors, the lr of
    the schedule at the update count, then the lr scales.  The host's part
    (:meth:`plan`) gives each update's lr and the family's step-dependent
    factors (bias corrections, RAdam's rectification, Adafactor's decay
    rate, NovoGrad's first step) as one device tensor (``hyper``), so the
    tensor work of a step runs unchanged from a CUDA graph.

    ``process_group``: the gradients (the accumulated mean under
    ``update_freq``) are averaged over its ranks once per applied update,
    before the clip and the update, in one all-reduce
    (``parallel/mesh.py::all_reduce_grads``), so every rank applies the
    global batch's update, as optax does on JAX's replicated gradient.  On
    a grid (a ``parallel/mesh.py::Mesh``) ``shards`` names the params that
    hold a shard of a split leaf (``mesh.shard_keys``): their gradients are
    averaged over the data group and the rest over every rank; their state
    slots are the shard's; and the clip's global norm and the per-tensor
    norms of LAMB and NovoGrad sum their squares over the model group, so
    each element counts once.  Adafactor chooses its factored dims on the
    whole leaf (dim 0 times the model size) and takes every mean over the
    split dim as the shard's sum summed over the model group, so each rank
    computes its slice of what optax computes on the whole leaf; each slot
    records the dim it is split on (:attr:`split`), which
    ``parallel/mesh.py`` cuts, glues and broadcasts along."""

    def __init__(self, named_params, lr_schedule: Callable[[int], float],
                 weight_decay: float = 0.05, betas: tuple[float, float] = (0.9, 0.95),
                 eps: float = 1e-8, update_freq: int = 1, clip_grad: float | None = None,
                 wd_mask: Mapping[str, bool] | None = None,
                 lr_scales: Mapping[str, float] | None = None, opt: str = "adamw",
                 momentum: float = 0.9, process_group=None, shards=None):
        self.opt = family(opt)
        self.mesh = as_mesh(process_group)
        if self.mesh.model > 1 and shards is None:
            raise ValueError("a model axis needs the names of the params that hold a shard "
                             "(shards=mesh.shard_keys(model))")
        named = [(n, p) for n, p in named_params if p.requires_grad]
        decay = pretrain_wd_mask(named) if wd_mask is None else wd_mask
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.decay = [decay[n] for n, _ in named]
        self.shards = [n in (shards or ()) for n, _ in named]
        if any(self.shards) and self.mesh.model == 1:
            raise ValueError("params flagged as shards without a model axis: their whole "
                             "leaves are unknown")
        # each param's factored dims (Adafactor), chosen on the whole leaf: a
        # shard's dim 0 times the model size
        self.factored = [factored_dims((p.shape[0] * self.mesh.model, *p.shape[1:]) if s
                                       else p.shape) if self.opt == "adafactor" else None
                         for p, s in zip(self.params, self.shards)]
        self.scales = None if lr_scales is None else [lr_scales[n] for n, _ in named]
        self.lr_schedule = lr_schedule
        self.weight_decay, self.betas, self.eps = weight_decay, betas, eps
        self.momentum = momentum
        self.update_freq, self.clip_grad = update_freq, clip_grad
        self.slots = {key: [self._slot(key, p, f) for p, f in zip(self.params, self.factored)]
                      for key in SLOTS[self.opt]}
        # each slot's split dim (None: whole on every rank)
        self.split = {key: [self._slot_split(key, s, f) for s, f in zip(self.shards, self.factored)]
                      for key in self.slots}
        self.acc = [torch.zeros_like(p) for p in self.params] if update_freq > 1 else None
        self.count = 0  # applied updates
        self.mini_step = 0
        # the host's values of the next update (see _hyper), written before
        # each step into a device tensor, so a captured step reads them anew
        self.hyper = torch.zeros(len(self._hyper(0)), dtype=torch.float32,
                                 device=self.params[0].device if self.params else None)

    def _slot(self, key: str, p: torch.Tensor, dims) -> torch.Tensor:
        if self.opt == "novograd" and key == "nu":
            return torch.zeros((), dtype=p.dtype, device=p.device)  # a norm a tensor
        if self.opt == "adafactor":
            if dims is None:
                return torch.zeros_like(p) if key == "v" else p.new_zeros(1)
            d1, d0 = dims
            drop = {"v_row": d0, "v_col": d1}.get(key)
            if drop is None:
                return p.new_zeros(1)
            # the shard's dims but the one reduced away: a split dim kept is the shard's
            return p.new_zeros([n for i, n in enumerate(p.shape) if i != drop])
        return torch.zeros_like(p)

    def _slot_split(self, key: str, shard: bool, dims) -> int | None:
        """The dim a slot of a split leaf is split on (the param's dim 0,
        where the slot keeps it), else None."""
        if not shard or (self.opt == "novograd" and key == "nu"):
            return None
        if self.opt == "adafactor":
            if dims is None:
                return 0 if key == "v" else None
            kept = {"v_row": dims[1] != 0, "v_col": dims[0] != 0}.get(key, False)
            return 0 if kept else None
        return 0

    @property
    def mu(self):
        return self.slots.get("mu")

    @property
    def nu(self):
        return self.slots.get("nu")

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a step changes besides the grads: params, state
        slots and the accumulated gradient."""
        return [*self.params, *(t for ts in self.slots.values() for t in ts), *(self.acc or [])]

    def state_shards(self) -> list[bool]:
        """For each of :meth:`state_tensors`, whether it is a shard: the
        params that hold one, the slots :attr:`split` records a dim of, and
        their accumulated gradients."""
        slots = [d is not None for ds in self.split.values() for d in ds]
        return [*self.shards, *slots, *(self.shards if self.acc is not None else [])]

    def state_split_dims(self) -> dict[str, dict[str, int]]:
        """For each key of :meth:`state_dict` that holds a tensor a param,
        the params whose tensor there is a shard and the dim it is split on."""
        out = {key: {n: d for n, d in zip(self.names, ds) if d is not None}
               for key, ds in self.split.items()}
        if self.acc is not None:
            out["acc"] = {n: 0 for n, s in zip(self.names, self.shards) if s}
        return out

    def _sum_sq(self, t: torch.Tensor, shard: bool) -> torch.Tensor:
        """``t``'s sum of squares, over the whole leaf where ``t`` is a shard
        of it."""
        sq = t.square().sum()
        return sum_(sq, self.mesh.model_group) if shard else sq

    def _norm(self, t: torch.Tensor, shard: bool) -> torch.Tensor:
        return self._sum_sq(t, True).sqrt() if shard else t.norm()

    def state_dict(self) -> dict:
        """Each state slot (``mu`` and ``nu`` for the Adam families) and the
        accumulated gradient mean under ``update_freq`` > 1, keyed by param
        name, the family, the update count and the micro-step within the
        accumulation: tensors, strings and ints only."""
        per_name = lambda ts: None if ts is None else dict(zip(self.names, ts))
        return {**{key: per_name(ts) for key, ts in self.slots.items()},
                "acc": per_name(self.acc), "opt": self.opt, "count": self.count,
                "mini_step": self.mini_step}

    def load_state_dict(self, state: Mapping) -> None:
        """Copy ``state`` (from :meth:`state_dict`, on any device) into this
        optimizer's tensors, which stay on their params' device."""
        theirs_opt = state.get("opt", "adamw")
        if theirs_opt != self.opt:
            raise ValueError(f"optimizer state of --opt {theirs_opt} given to --opt {self.opt}")
        for key, mine in (*self.slots.items(), ("acc", self.acc)):
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

    def _hyper(self, count: int) -> list[float]:
        """The host's values of update ``count`` (0-based): its lr, then the
        family's factors of the step t = count + 1."""
        b1, b2 = self.betas
        t = count + 1
        lr = self.lr_schedule(count)
        if self.opt in ("adamw", "adam", "lamb"):
            return [lr, 1 - b1 ** t, 1 - b2 ** t]
        if self.opt == "nadam":
            return [lr, 1 - b1 ** t, 1 - b2 ** t, 1 - b1 ** (t + 1)]
        if self.opt == "radam":
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            ro = ro_inf - 2 * t * b2 ** t / (1 - b2 ** t)
            rect = ro >= RADAM_THRESHOLD
            r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                          / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro)) if rect else 0.0
            return [lr, 1 - b1 ** t, 1 - b2 ** t, r, float(rect)]
        if self.opt == "adafactor":
            return [lr, 1.0 - t ** -ADAFACTOR["decay_rate"]]
        if self.opt == "novograd":
            return [lr, float(count == 0)]
        return [lr]

    def plan(self, n: int) -> list[tuple[int, bool, list[float]]]:
        """The next ``n`` steps from the host's state, which does not change:
        each step's micro-step within the accumulation, whether it applies
        an update, and that update's ``hyper`` values (for the Adam families
        the lr and the bias corrections ``1 - b1^t``, ``1 - b2^t``; zeros
        where it applies none)."""
        period = self.update_freq if self.acc is not None else 1
        mini, count, out = self.mini_step, self.count, []
        width = self.hyper.numel()
        for _ in range(n):
            applies = mini + 1 == period
            out.append((mini, applies, self._hyper(count) if applies else [0.0] * width))
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
        ``applies``, the update with ``hyper``'s values.  :meth:`step` runs
        it eagerly; ``train/step.py::ChainedStep`` captures it with each
        step's micro-step, kind and ``hyper`` row."""
        grads = self._grads()
        if self.acc is not None:
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (mini + 1))
            if not applies:
                return
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
        all_reduce_grads(grads, self.mesh, self.shards)
        if self.clip_grad is not None:
            norm = global_norm(grads, self.shards, self.mesh.model_group)
            scale = torch.where(norm < self.clip_grad, torch.ones_like(norm),
                                self.clip_grad / norm)
            torch._foreach_mul_(grads, scale)
        dec = [i for i, d in enumerate(self.decay) if d] if self.weight_decay else []
        if self.opt in COUPLED and dec:
            # torch's L2: the decay enters the gradient before the statistics
            grads = list(grads)
            for i in dec:
                grads[i] = grads[i] + self.weight_decay * self.params[i]
        upd = getattr(self, f"_{self.opt}")(grads, hyper, dec)
        if self.scales is not None:
            torch._foreach_mul_(upd, self.scales)
        torch._foreach_mul_(upd, hyper[0])
        torch._foreach_sub_(self.params, upd)

    # -- each family's update direction (before the lr), optax's arithmetic --
    def _adam_moments(self, grads, hyper):
        b1, b2 = self.betas
        mu, nu = self.slots["mu"], self.slots["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
        return torch._foreach_div(mu, hyper[1]), torch._foreach_div(nu, hyper[2])

    def _adam_direction(self, grads, hyper):
        mu_hat, nu_hat = self._adam_moments(grads, hyper)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        return torch._foreach_div(mu_hat, denom)

    def _adamw(self, grads, hyper, dec):
        upd = self._adam_direction(grads, hyper)
        if dec:
            torch._foreach_add_([upd[i] for i in dec], [self.params[i] for i in dec],
                                alpha=self.weight_decay)
        return upd

    def _adam(self, grads, hyper, dec):
        return self._adam_direction(grads, hyper)

    def _nadam(self, grads, hyper, dec):
        b1 = self.betas[0]
        _, nu_hat = self._adam_moments(grads, hyper)
        # Dozat's Nesterov step: mu bias-corrected one step ahead, plus g
        return [(b1 * (m / hyper[3]) + (1 - b1) * (g / hyper[1])) / (v.sqrt() + self.eps)
                for m, g, v in zip(self.slots["mu"], grads, nu_hat)]

    def _radam(self, grads, hyper, dec):
        mu_hat, nu_hat = self._adam_moments(grads, hyper)
        return [torch.where(hyper[4] > 0, hyper[3] * m / (v.sqrt() + self.eps), m)
                for m, v in zip(mu_hat, nu_hat)]

    def _lamb(self, grads, hyper, dec):
        upd = self._adamw(grads, hyper, dec)
        out = []
        for u, p, s in zip(upd, self.params, self.shards):
            pn, un = self._norm(p, s), self._norm(u, s)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un)
            out.append(u * ratio)
        return out

    def _trace(self, updates, nesterov: bool):
        trace = self.slots["trace"]
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, updates)
        if not nesterov:
            return [t.clone() for t in trace]
        return [u + self.momentum * t for u, t in zip(updates, trace)]

    def _sgd(self, grads, hyper, dec):
        return self._trace(grads, nesterov=True)

    def _momentum(self, grads, hyper, dec):
        return self._trace(grads, nesterov=False)

    def _adadelta(self, grads, hyper, dec):
        rho, eps, out = ADADELTA_RHO, self.eps, []
        for g, e_g, e_x in zip(grads, self.slots["e_g"], self.slots["e_x"]):
            e_g.mul_(rho).add_((1 - rho) * g * g)
            u = (e_x + eps).sqrt() / (e_g + eps).sqrt() * g
            e_x.mul_(rho).add_((1 - rho) * u * u)
            out.append(u)
        return out

    def _rmsprop(self, grads, hyper, dec):
        nu = self.slots["nu"]
        torch._foreach_mul_(nu, RMSPROP_DECAY)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - RMSPROP_DECAY)
        scaled = [g / (v.sqrt() + self.eps) for g, v in zip(grads, nu)]
        return self._trace(scaled, nesterov=False)

    def _mean(self, x: torch.Tensor, dim: int, split: int | None,
              keepdim: bool = False) -> torch.Tensor:
        """``x``'s mean over ``dim`` of the whole leaf: over the split dim,
        the shard's sum (f32) summed over the model group over the whole
        width."""
        if dim != split:
            return x.mean(dim=dim, keepdim=keepdim)
        total = sum_(x.float().sum(dim=dim, keepdim=keepdim), self.mesh.model_group)
        return (total / (x.shape[dim] * self.mesh.model)).to(x.dtype)

    def _adafactor(self, grads, hyper, dec):
        decay, eps, out = hyper[1], ADAFACTOR["epsilon"], []
        for i, (g, dims) in enumerate(zip(grads, self.factored)):
            v_row, v_col, v = (self.slots[k][i] for k in ("v_row", "v_col", "v"))
            sq = g * g + eps
            if dims is None:
                v.mul_(decay).add_((1 - decay) * sq)
                out.append(g * v.rsqrt())
                continue
            d1, d0 = dims
            split = 0 if self.shards[i] else None
            v_row.mul_(decay).add_((1 - decay) * self._mean(sq, d0, split))
            v_col.mul_(decay).add_((1 - decay) * self._mean(sq, d1, split))
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_mean = self._mean(v_row, reduced_d1, self.split["v_row"][i], keepdim=True)
            row_factor = (v_row / row_mean).rsqrt()
            out.append(g * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1))
        return out

    def _novograd(self, grads, hyper, dec):
        b1, b2 = self.betas
        first = hyper[1]
        decayed, out = set(dec), []
        for i, (g, p, mu, nu) in enumerate(zip(grads, self.params, self.slots["mu"],
                                               self.slots["nu"])):
            n2 = self._sum_sq(g, self.shards[i])
            # the first step takes the norm as it is (optax's init_nu)
            nu.copy_(torch.where(first > 0, n2, b2 * nu + (1 - b2) * n2))
            u = g / (nu.sqrt() + self.eps)
            if i in decayed:
                u = u + self.weight_decay * p
            mu.mul_(b1).add_(u)
            out.append(mu.clone())
        return out


class AdamW(Optimizer):
    """:class:`Optimizer` of the ``adamw`` family (pretraining's)."""

    def __init__(self, named_params, lr_schedule: Callable[[int], float],
                 weight_decay: float = 0.05, betas: tuple[float, float] = (0.9, 0.95),
                 eps: float = 1e-8, update_freq: int = 1, clip_grad: float | None = None,
                 wd_mask: Mapping[str, bool] | None = None,
                 lr_scales: Mapping[str, float] | None = None, process_group=None,
                 shards=None):
        super().__init__(named_params, lr_schedule, weight_decay, betas, eps, update_freq,
                         clip_grad, wd_mask, lr_scales, opt="adamw",
                         process_group=process_group, shards=shards)


def write_host_values(dst: torch.Tensor, values) -> None:
    """``dst`` = ``values`` (host numbers) without waiting for the device: on
    a card through pinned memory, copied in stream order (the pinned block is
    not reused before the copy has run)."""
    src = torch.tensor(values, dtype=dst.dtype)
    if dst.is_cuda:
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


def global_norm(tensors, shards=None, model_group=None) -> torch.Tensor:
    """The L2 norm of ``tensors`` together.  Those that ``shards`` flags are
    this rank's slices of leaves split over ``model_group``: their squares
    are summed over it, so that each element counts once."""
    tensors = list(tensors)
    flags = list(shards) if shards is not None else [False] * len(tensors)
    total = sum(t.float().square().sum() for t, s in zip(tensors, flags) if not s)
    if any(flags):
        split = sum(t.float().square().sum() for t, s in zip(tensors, flags) if s)
        total = total + sum_(split, model_group)
    return torch.sqrt(total)

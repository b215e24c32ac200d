"""The pretraining step (port of ``mmearth_tpu/train/step.py::make_pretrain_step``):
aligned random crop, NaN zeroing, masked forward, multi-pretext loss,
backward and the optimizer update, with no host synchronisation; and k of
them in one dispatch (``make_chained_step``), on a card one replay of a
captured CUDA graph.

Each step's random draws (crop offsets, then the mask's noise) come from
``fold_in(gen, step)`` outside the step itself (:func:`draw`), so the crops
and masks are a function of (seed, step) alone, whether the step runs
eagerly or from a graph, and ``--steps_per_dispatch k`` trains as k = 1 does.

Under a process group (the model's ``process_group``, one rank a GPU), each
rank draws the global batch's crops and noise from the same generator and
keeps its own rows, as JAX draws with one key at the global batch's shapes;
the model's loss (and the global scope's GRN statistic) is the global
batch's; and the optimizer averages the gradients over the ranks, once per
applied update (``train/optim.py``), in the step and in a captured chain
alike.  On a grid with a ``model`` axis (``parallel/mesh.py::shard_params``)
the model's process group is the data group: rows and draws follow the
data index, so the ranks of one model group draw the same crops, mask and
drop path for the same rows.  ``ChainedStep`` runs on a grid unchanged; on
a card its capture needs collectives a CUDA graph can record (NCCL).
"""
from __future__ import annotations

import time
from typing import Iterable, Iterator, Mapping, NamedTuple, Optional

import torch

from .. import ops
from ..models import fcmae as fcmae_lib
from ..parallel.mesh import shard_rows, world_size
from .optim import AdamW, global_norm, write_host_values


def to_device(batch: Mapping, device) -> dict[str, torch.Tensor]:
    """numpy (or tensor) batch -> tensors on ``device``; unpinned host
    memory is pinned first (a loader asked to feed a card pins in its worker)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(v)
        if t.device.type == "cpu" and torch.device(device).type == "cuda" and not t.is_pinned():
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def device_batches(batches: Iterable[Mapping], device) -> Iterator[dict[str, torch.Tensor]]:
    """``batches`` (host dicts) on ``device``.  On a card each batch's copy
    is issued on a side stream one batch ahead of the consumer, whose stream
    waits on the copy's event; each tensor is then marked as used by the
    consumer's stream (``record_stream``), so its memory is not handed out
    again before the consumer's work on it has run."""
    dev = torch.device(device)
    if dev.type != "cuda":
        for host in batches:
            yield to_device(host, dev)
        return
    side = torch.cuda.Stream(dev)
    pending = None
    for host in batches:
        with torch.cuda.stream(side):
            nxt = to_device(host, dev)
        done = torch.cuda.Event()
        done.record(side)
        if pending is not None:
            yield _arrived(*pending, dev)
        pending = nxt, done
    if pending is not None:
        yield _arrived(*pending, dev)


def _arrived(batch: dict, done: torch.cuda.Event, dev) -> dict:
    stream = torch.cuda.current_stream(dev)
    stream.wait_event(done)
    for t in batch.values():
        t.record_stream(stream)
    return batch


def fold_in(gen: torch.Generator, step: int) -> torch.Generator:
    """A generator for one step, a function of ``gen``'s seed and ``step``
    only (``jax.random.fold_in`` of the JAX step), so a resumed run draws the
    same crops and masks."""
    return torch.Generator(device=gen.device).manual_seed(
        (gen.initial_seed() * 1_000_003 + step) % (2 ** 63))


class Draws(NamedTuple):
    """One step's random inputs: the crop offsets (N,) (None without a
    crop) and the mask's noise (N, L) (None with a given mask)."""
    tops: Optional[torch.Tensor]
    lefts: Optional[torch.Tensor]
    noise: Optional[torch.Tensor]


def draw(model: fcmae_lib.FCMAE, images: torch.Tensor, step: int, gen: torch.Generator,
         crop: bool, noise: bool = True) -> Draws:
    """The draws of step ``step`` for an (N, H, W, C) batch of ``images``,
    from ``fold_in(gen, step)`` in the order the step consumes them: the
    crop's ``tops`` then ``lefts`` (``aligned_random_crop``), then the
    mask's noise (``gen_random_mask``).  Under the model's process group
    each is drawn for the global batch of N * world rows, of which the
    rank's own N are kept."""
    g = fold_in(gen, step)
    n, h, w = images.shape[:3]
    dev, size = images.device, model.img_size
    group = model.process_group
    n_all = n * world_size(group)
    rows = slice(*shard_rows(n, group))
    tops = lefts = None
    if crop:
        tops = torch.randint(0, h - size + 1, (n_all,), generator=g, device=dev)[rows]
        lefts = torch.randint(0, w - size + 1, (n_all,), generator=g, device=dev)[rows]
    return Draws(tops, lefts, torch.randn(n_all, model.num_patches, generator=g,
                                          device=dev)[rows] if noise else None)


def _crops(model: fcmae_lib.FCMAE, images: torch.Tensor, random_crop: bool) -> bool:
    return random_crop and images.shape[1] > model.img_size


def _step(model, opt: AdamW, batch: Mapping[str, torch.Tensor], draws: Draws,
          mask: Optional[torch.Tensor], loss_sum: Optional[torch.Tensor],
          update) -> dict[str, torch.Tensor]:
    """The step's tensor work on its draws; ``update()`` runs the optimizer."""
    if draws.tops is not None:
        batch = fcmae_lib.aligned_random_crop(batch, model.img_size, tops=draws.tops,
                                              lefts=draws.lefts)
    batch = fcmae_lib.zero_nan_inputs(batch)
    opt.zero_grad()
    loss, _, _, loss_dict, log_vars, weighted = model(batch, mask=mask, noise=draws.noise)
    loss.backward()
    grads = [p.grad for p in opt.params if p.grad is not None]
    # this rank's gradient: the optimizer averages them over the ranks
    metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads).detach()}
    update()
    if loss_sum is not None:
        loss_sum.add_(metrics["loss"].float())
    metrics.update({f"loss_{k}": v.detach() for k, v in loss_dict.items()})
    if log_vars is not None:
        metrics["log_vars"] = log_vars.detach().clone()
        metrics["normalized_loss"] = weighted.detach().sum()
    return metrics


def pretrain_step(model: fcmae_lib.FCMAE, opt: AdamW, batch: Mapping[str, torch.Tensor],
                  step: int, gen: torch.Generator, random_crop: bool = True,
                  mask: Optional[torch.Tensor] = None,
                  loss_sum: Optional[torch.Tensor] = None) -> dict[str, torch.Tensor]:
    """One training step on ``batch`` (NHWC modality tensors on the model's
    device, at tile resolution).  ``fold_in(gen, step)`` (``gen`` on that
    device) draws the crop offsets and the mask; ``mask`` overrides the drawn
    mask.  Adds the loss
    to ``loss_sum`` in place when given.  Returns detached on-device metrics:
    ``loss``, ``grad_norm`` (of this rank's gradient, before the optimizer
    averages it over the ranks), ``loss_<modality>``, and with uncertainty
    weighting ``log_vars`` and ``normalized_loss``.  Under a process group
    ``batch`` and ``mask`` are this rank's rows of the global batch."""
    images = batch["sentinel2"]
    draws = draw(model, images, step, gen, _crops(model, images, random_crop), mask is None)
    return _step(model, opt, batch, draws, mask, loss_sum, opt.step)


class ChainedStep:
    """k pretraining steps in one dispatch (port of ``make_chained_step``,
    JAX ``train/step.py:99-117``), over ``inputs``: static (k, N, H, W, C)
    slots of each modality, on the model's device, that :meth:`load` fills
    (a caller that trains on one batch may pass ``batch.expand(k, ...)``).

    A call writes the k steps' draws (:func:`draw`, ``fold_in(gen, step +
    i)``) and AdamW's lr and bias corrections into static slots, then runs
    the k steps.  On a card that is one replay of a CUDA graph, captured on
    the first call with each pattern of micro-steps and updates that
    ``update_freq`` gives a chain (one graph per pattern: k steps from each
    micro-step the chain starts at), after warm-up steps on a side stream
    whose effect on the params and AdamW's state is undone; if the capture
    fails it raises.  On the CPU the same k steps run one after another.
    Either way the steps' arithmetic, draws and order are those of k calls
    of :func:`pretrain_step`.  Returns the last step's metrics and the k
    losses, copied out of the static outputs.

    The wrappers' launch counters count what a capture records and not its
    replays: ``recorded`` holds each graph's launches by kernel, and
    ``replayed`` sums them over the replays."""

    def __init__(self, model: fcmae_lib.FCMAE, opt: AdamW, inputs: Mapping[str, torch.Tensor],
                 random_crop: bool = True):
        self.model, self.opt, self.inputs = model, opt, dict(inputs)
        images = self.inputs["sentinel2"]
        self.k, n = images.shape[:2]
        dev = self.device = images.device
        self.crop = _crops(model, images[0], random_crop)
        self.tops = torch.zeros(self.k, n, dtype=torch.long, device=dev)
        self.lefts = torch.zeros_like(self.tops)
        self.noise = torch.zeros(self.k, n, model.num_patches, device=dev)
        self.hyper = torch.zeros(self.k, opt.hyper.numel(), device=dev)
        self.loss_sum = torch.zeros((), device=dev)
        self.losses = torch.zeros(self.k, device=dev)
        self.graphs: dict[tuple, tuple] = {}  # pattern -> (graph, static metrics)
        self.recorded: dict[tuple, dict[str, int]] = {}
        self.replayed = dict.fromkeys(ops.launch_counts(), 0)
        self.capture_seconds: dict[tuple, dict[str, float]] = {}
        self.steps = {"eager": 0, "recorded": 0, "replayed": 0}

    def report(self) -> dict:
        """The first graph's warm-up, record and instantiate seconds, the
        steps run eagerly (warm-ups; every step on the CPU), recorded and
        replayed, and the launches the replays ran."""
        return {"capture_s": next(iter(self.capture_seconds.values()), None),
                "steps": dict(self.steps), "replayed_launches": dict(self.replayed)}

    def load(self, batches: Mapping[str, torch.Tensor]) -> None:
        """Copy a stacked (k, N, ...) superbatch into the static slots."""
        for key, slot in self.inputs.items():
            slot.copy_(batches[key], non_blocking=True)

    def __call__(self, step: int, gen: torch.Generator,
                 loss_sum: Optional[torch.Tensor] = None):
        plan = self.opt.plan(self.k)
        pattern = tuple((mini, applies) for mini, applies, _ in plan)
        write_host_values(self.hyper, [hyper for _, _, hyper in plan])
        images = self.inputs["sentinel2"][0]
        for i in range(self.k):
            d = draw(self.model, images, step + i, gen, self.crop)
            if self.crop:
                self.tops[i].copy_(d.tops)
                self.lefts[i].copy_(d.lefts)
            self.noise[i].copy_(d.noise)
        if loss_sum is None:
            self.loss_sum.zero_()
        else:
            self.loss_sum.copy_(loss_sum)
        if self.device.type == "cuda":
            if pattern not in self.graphs:
                self._capture(pattern)
            graph, metrics = self.graphs[pattern]
            graph.replay()
            self.steps["replayed"] += self.k
            for key, n in self.recorded[pattern].items():
                self.replayed[key] += n
        else:
            metrics = self._steps(pattern)
        for _, applies in pattern:
            self.opt.advance(applies)
        if loss_sum is not None:
            loss_sum.copy_(self.loss_sum)
        return {key: v.clone() for key, v in metrics.items()}, self.losses.clone()

    def _steps(self, pattern: tuple, kind: str = "eager") -> dict[str, torch.Tensor]:
        """The chain's k steps on the static slots, run (``kind`` "eager")
        or under capture ("recorded")."""
        metrics = {}
        for i, (mini, applies) in enumerate(pattern):
            batch = {key: v[i] for key, v in self.inputs.items()}
            draws = Draws(self.tops[i] if self.crop else None,
                          self.lefts[i] if self.crop else None, self.noise[i])
            metrics = _step(self.model, self.opt, batch, draws, None, self.loss_sum,
                            lambda: self.opt.update(self.hyper[i], mini, applies))
            self.losses[i].copy_(metrics["loss"])
        self.steps[kind] += len(pattern)
        return metrics

    def _capture(self, pattern: tuple) -> None:
        """Warm up (the chain's steps on a side stream: plan caches, the
        kernels' shared-memory attributes, cuBLAS workspaces, the autograd
        threads), restore the params, AdamW's state and the loss sum, then
        capture the chain into a graph with its own memory pool."""
        opt = self.opt
        state = [*opt.state_tensors(), self.loss_sum]
        t0 = time.perf_counter()
        with torch.no_grad():
            saved = [t.clone() for t in state]
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._steps(pattern)
        current.wait_stream(side)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        opt.zero_grad()
        del saved
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        # thread_local: the loader's worker may pin host memory meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            metrics = self._steps(pattern, "recorded")
            t2 = time.perf_counter()
        after = ops.launch_counts()
        self.recorded[pattern] = {key: after[key] - before[key] for key in after}
        self.graphs[pattern] = graph, metrics
        self.capture_seconds[pattern] = {"warmup": t1 - t0, "record": t2 - t1,
                                         "instantiate": time.perf_counter() - t2}

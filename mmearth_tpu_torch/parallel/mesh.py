"""The ``data`` axis of ``mmearth_tpu/parallel/mesh.py`` on ``torch.distributed``.

JAX trains on a mesh whose ``data`` axis splits each batch over the devices
while the params stay replicated, and XLA computes every reduction of the
jitted step (the loss's sums, the gradients, the GRN statistic under the
global scope, BatchNorm's statistics) over the global batch.  The port runs
one process per GPU, started by ``torchrun`` (one process group: NCCL on
the card, gloo on the CPU), and makes the same reductions explicit:

  * each rank loads its shard of the samples (the loaders' ``shard=(rank,
    world)``), so the global batch is the ranks' batches in rank order, as
    ``make_array_from_process_local_data`` lays it out;
  * a sum that XLA would take over the global batch goes through
    :func:`all_reduce_sum` (forward: the sum over the ranks; backward: the
    same sum of the gradient), so every rank computes the global value;
  * the gradients are averaged over the ranks by :func:`all_reduce_grads`
    (one all-reduce of one flat f32 buffer) before the optimizer uses them;
  * the state is broadcast from rank 0 after it is built or resumed
    (:func:`broadcast_state`), and only rank 0 writes.

Nothing here keeps the process group in a global: :func:`init_distributed`
returns it, and each module that needs it (``MaskedGRN``, ``BatchNorm``,
``DropPath``, ``FCMAE``'s loss; :func:`set_process_group` gives it to them)
or the optimizer is handed it.  ``None`` means one process: every helper is
then the identity.  The tensor-parallel ``model`` axis of the JAX module
(``param_sharding_rules``, ``shard_params``, ``place_state``) is not here.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Iterable, NamedTuple, Optional

import torch
import torch.distributed as dist


class Dist(NamedTuple):
    """A rank's device, its process group (None: one process, no group) and
    whether :func:`init_distributed` made the group (:func:`close` then
    destroys it)."""

    device: torch.device
    group: Optional["dist.ProcessGroup"]
    owned: bool


def _rank_device(dev: torch.device, local_rank: int) -> torch.device:
    """``cuda`` without an index becomes ``cuda:LOCAL_RANK`` (torchrun's
    variable, else ``local_rank`` where >= 0, else 0), made current."""
    if dev.type != "cuda":
        return dev
    if dev.index is None:
        env = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(env) if env is not None else max(local_rank, 0))
    torch.cuda.set_device(dev)
    return dev


def init_distributed(device="cuda", init_method: str = "env://",
                     local_rank: int = -1) -> Dist:
    """The rank's device and process group (JAX ``init_distributed``).

    A group the caller already made is taken as it is.  Otherwise, under
    ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set; ``MASTER_ADDR`` and
    ``MASTER_PORT`` read through ``init_method``) a group is started: NCCL
    for a CUDA device, bound to it, gloo for the CPU.  Without either, one
    process runs without a group.  A ``cuda`` device without an index is
    rank r's ``cuda:LOCAL_RANK``."""
    dev = torch.device(device)
    if dist.is_available() and dist.is_initialized():
        return Dist(_rank_device(dev, local_rank), dist.group.WORLD, False)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return Dist(_rank_device(dev, local_rank), None, False)
    dev = _rank_device(dev, local_rank)
    if dev.type == "cuda":
        dist.init_process_group("nccl", init_method=init_method, device_id=dev)
    else:
        dist.init_process_group("gloo", init_method=init_method)
    return Dist(dev, dist.group.WORLD, True)


def close(d: Dist) -> None:
    """Destroy the group where :func:`init_distributed` made it."""
    if d.owned and dist.is_initialized():
        dist.destroy_process_group()


def rank(group=None) -> int:
    return dist.get_rank(group) if group is not None else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if group is not None else 1


def is_main(group=None) -> bool:
    return rank(group) == 0


class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over the group's ranks, with the same sum as its
    backward: rank r's input reaches every rank's output, so its gradient
    is the sum of theirs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (:class:`AllReduceSum`);
    ``x`` itself without a group."""
    return x if group is None else AllReduceSum.apply(x, group)


def sum_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (contiguous) summed over the ranks in place, outside autograd;
    returns it."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks (a new tensor), outside autograd."""
    if group is None:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    return sum_(out, group).div_(world_size(group))


def all_reduce_grads(grads: Iterable[torch.Tensor], group) -> None:
    """Average ``grads`` over the ranks in place: one all-reduce of one flat
    buffer of them all (f32, or the widest of their dtypes)."""
    grads = list(grads)
    if group is None or not grads:
        return
    dtype = functools.reduce(torch.promote_types, (g.dtype for g in grads), torch.float32)
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])
    sum_(flat, group).div_(world_size(group))
    parts = flat.split([g.numel() for g in grads])
    # one multi-tensor copy back, not a launch a tensor (host time in eager steps)
    torch._foreach_copy_(grads, [p.view(g.shape) for p, g in zip(parts, grads)])


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, opt=None, group=None) -> None:
    """Rank 0's params, buffers and optimizer state on every rank."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    tensors = [*model.parameters(), *model.buffers(),
               *(opt.state_tensors() if opt is not None else ())]
    for t in tensors:
        dist.broadcast(t.data, src, group=group)


def set_process_group(model: torch.nn.Module, group) -> torch.nn.Module:
    """Give ``group`` to every submodule of ``model`` that takes one (those
    with a ``process_group`` attribute); returns ``model``."""
    for m in model.modules():
        if hasattr(m, "process_group"):
            m.process_group = group
    return model


def shard_rows(n: int, group) -> tuple[int, int]:
    """Rank r's rows [start, stop) of a global batch of ``n * world`` rows
    whose rank-local part has ``n`` rows."""
    r = rank(group)
    return r * n, (r + 1) * n


@contextlib.contextmanager
def main_first(group):
    """Rank 0 runs the body before the other ranks do (a split packed once
    and then read by all)."""
    if group is not None and not is_main(group):
        dist.barrier(group)
    yield
    if group is not None and is_main(group):
        dist.barrier(group)


def barrier(group) -> None:
    if group is not None:
        dist.barrier(group)


def gather_objects(obj, group) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` without a group)."""
    if group is None:
        return [obj]
    out = [None] * world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out

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
then the identity.

The ``model`` axis (tensor parallelism).  :func:`create_mesh` lays the ranks
out as JAX's ``devices.reshape(data, model)``: rank r at data index ``r //
model`` and model index ``r % model``.  The ranks of one data index (its
*model group*) hold the same samples; the ranks of one model index (its
*data group*) hold the same shard of every split leaf.  The leaves
:func:`param_sharding_rules` picks (JAX's rule: the output channels of
``pwconv1``, ``proj`` and the ``pred_`` heads, where the axis divides them)
keep on each rank only the contiguous slice of their dim 0 that its model
index names (:func:`shard_params`); everything else is replicated.  Then:

  * every batch reduction (the loss's sums, GRN, BatchNorm, the draws' rows)
    runs over the data group: :func:`set_process_group` hands the data group
    to the modules and the model group to those that hold a split leaf;
  * a product on a split leaf is column-parallel (:func:`column_linear`):
    each rank computes its slice of the output channels, the slices are
    gathered, and the backward sums dx over the model group; a kernel that
    needs the whole weight is given it gathered (:func:`gather_shards`),
    and takes back the rank's slice of the gradient it computes;
  * the gradients of split leaves are averaged over the data group, those
    of replicated leaves over every rank (which keeps the copies of a
    replicated leaf on the ranks of a model group bit-identical);
  * a norm counts each element once: a split leaf's sum of squares is
    summed over the model group, and so is the sum behind each of
    Adafactor's means over a split dim (``train/optim.py``);
  * a checkpoint holds the whole leaves and optimizer slots
    (:func:`gather_state`, each slot glued along the dim the optimizer
    records), and a whole state is cut to the rank's slices when it is
    loaded (:func:`place_state`).

``create_mesh(W, 1, group)`` is the data axis alone: its data group is
``group`` itself, and every helper makes the calls it makes without a grid.
"""
from __future__ import annotations

import contextlib
import functools
import os
from typing import Iterable, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


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
    """The rank in ``group`` (in every rank of a :class:`Mesh`)."""
    group = group.world if isinstance(group, Mesh) else group
    return dist.get_rank(group) if group is not None else 0


def world_size(group=None) -> int:
    group = group.world if isinstance(group, Mesh) else group
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


class GatherShards(torch.autograd.Function):
    """The ranks' shards of a tensor concatenated along ``dim`` in the
    group's rank order.  Backward: the rank's slice of the gradient.  Every
    rank of a model group computes the whole gradient from the same samples,
    so nothing is summed (what GSPMD does around an opaque kernel)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // world_size(ctx.group)
        return grad.narrow(ctx.dim, rank(ctx.group) * n, n).contiguous(), None, None


class SumGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over the group: the
    input of a column-parallel product, whose ranks each give back the part
    of dx that their slice of the output channels makes."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def gather_shards(t: torch.Tensor, width: int, group) -> torch.Tensor:
    """A leaf of ``width`` rows along dim 0 whole: ``t`` itself where it is
    whole, else the model group's shards gathered (:class:`GatherShards`;
    the backward gives this rank's slice of the whole gradient)."""
    if t.shape[0] == width:
        return t
    if group is None:
        raise ValueError(f"a shard of {t.shape[0]} of {width} rows without a model group")
    return GatherShards.apply(t, 0, group)


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, width: int,
                  group) -> torch.Tensor:
    """``F.linear(x, weight, bias)`` of a leaf of ``width`` output channels.
    Where this rank holds a shard of them the product is column-parallel
    over the model ``group``: forward ``gather(x W_i^T + b_i)`` along the
    channels, backward dW_i and db_i from the rank's slice of dy and ``dx =
    sum over the group of dy_i W_i``.  Under ``torch.utils.checkpoint`` the
    recompute repeats the gather, in the same order on every rank."""
    if weight.shape[0] == width:
        return F.linear(x, weight, bias)
    if group is None:
        raise ValueError(f"a shard of {weight.shape[0]} of {width} channels without a model group")
    return GatherShards.apply(F.linear(SumGrad.apply(x, group), weight, bias), -1, group)


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


def _average(grads: list[torch.Tensor], group) -> None:
    """Average ``grads`` over the ranks of ``group`` in place: one all-reduce
    of one flat buffer of them all (f32, or the widest of their dtypes)."""
    if group is None or not grads:
        return
    dtype = functools.reduce(torch.promote_types, (g.dtype for g in grads), torch.float32)
    flat = torch.cat([g.reshape(-1).to(dtype) for g in grads])
    sum_(flat, group).div_(world_size(group))
    parts = flat.split([g.numel() for g in grads])
    # one multi-tensor copy back, not a launch a tensor (host time in eager steps)
    torch._foreach_copy_(grads, [p.view(g.shape) for p, g in zip(parts, grads)])


def all_reduce_grads(grads: Iterable[torch.Tensor], group, shards=None) -> None:
    """Average ``grads`` over the ranks in place.  ``group`` is a process
    group (every grad replicated: one flat all-reduce over it) or a
    :class:`Mesh`; ``shards`` flags the grads of split leaves, which are
    averaged over the data group, the rest over every rank: two flat
    all-reduces."""
    grads = list(grads)
    mesh = as_mesh(group)
    flags = list(shards) if shards is not None else [False] * len(grads)
    _average([g for g, s in zip(grads, flags) if not s], mesh.world)
    _average([g for g, s in zip(grads, flags) if s], mesh.data_group)


@torch.no_grad()
def broadcast_state(model: torch.nn.Module, opt=None, group=None) -> None:
    """Rank 0's params, buffers and optimizer state on every rank.  On a
    grid (``group`` a :class:`Mesh`) the split leaves and the optimizer
    tensors that ``opt`` records as split (``Optimizer.state_shards``) go
    from data index 0 over each data group, so that each rank keeps its own
    shard; the rest from global rank 0 over every rank."""
    mesh = as_mesh(group)
    if mesh.world is None:
        return
    split = shard_keys(model)
    tensors = [*(p for _, p in model.named_parameters()), *model.buffers(),
               *(opt.state_tensors() if opt is not None else ())]
    flags = [*(n in split for n, _ in model.named_parameters()), *(False for _ in model.buffers()),
             *(opt.state_shards() if opt is not None else ())]
    src = dist.get_global_rank(mesh.world, 0)
    shard_src = (dist.get_global_rank(mesh.data_group, 0) if mesh.data_group is not None
                 else None)
    for t, f in zip(tensors, flags):
        if not f:
            dist.broadcast(t.data, src, group=mesh.world)
        elif shard_src is not None:
            dist.broadcast(t.data, shard_src, group=mesh.data_group)


def set_process_group(model: torch.nn.Module, group) -> torch.nn.Module:
    """Give ``group`` to every submodule of ``model`` that takes one (those
    with a ``process_group`` attribute); returns ``model``.  For a
    :class:`Mesh` that is its data group, and the modules that may hold a
    split leaf (those with a ``model_group`` attribute) get its model
    group."""
    data, model_group = ((group.data_group, group.model_group) if isinstance(group, Mesh)
                         else (group, None))
    for m in model.modules():
        if hasattr(m, "process_group"):
            m.process_group = data
        if hasattr(m, "model_group"):
            m.model_group = model_group
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


# ---------------------------------------------------------------------------
# the data x model grid (JAX ``create_mesh`` with a ``model`` axis)
# ---------------------------------------------------------------------------
class Mesh(NamedTuple):
    """A rank's place on the ``data`` x ``model`` grid: every rank of it
    (``world``), the ranks of its model index (``data_group``: the same
    shard of every split leaf, each its own samples) and of its data index
    (``model_group``: the same samples, each its own shard), its two indices
    and the two sizes.  A group of one rank is None (nothing to reduce)."""

    world: Optional["dist.ProcessGroup"]
    data_group: Optional["dist.ProcessGroup"]
    model_group: Optional["dist.ProcessGroup"]
    data_index: int
    model_index: int
    data: int
    model: int


def create_mesh(data: int, model: int = 1, group=None) -> Mesh:
    """The grid of ``data`` x ``model`` ranks of ``group`` (None: one process),
    as JAX's ``create_mesh(data, model)`` lays out ``devices.reshape(data,
    model)``: the rank r of ``group`` at data index ``r // model`` and model
    index ``r % model``.  The data groups, then the model groups are made
    with ``dist.new_group``, every one on every rank in the same order.  At
    ``model`` 1 no group is made: the data group is ``group`` itself."""
    world = world_size(group)
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    r = rank(group)
    if model == 1:
        return Mesh(group, group, None, r, 0, data, 1)
    ranks = dist.get_process_group_ranks(group)
    at = lambda d, m: ranks[d * model + m]  # noqa: E731
    data_groups = ([dist.new_group([at(d, m) for d in range(data)]) for m in range(model)]
                   if data > 1 else [None] * model)
    model_groups = [dist.new_group([at(d, m) for m in range(model)]) for d in range(data)]
    return Mesh(group, data_groups[r % model], model_groups[r // model], r // model, r % model,
                data, model)


def as_mesh(group) -> Mesh:
    """``group`` as a grid: a :class:`Mesh` as it is; a process group (or
    None) as the data axis alone, ``create_mesh(W, 1, group)``."""
    if isinstance(group, Mesh):
        return group
    return Mesh(group, group, None, rank(group), 0, world_size(group), 1)


SHARDED_LEAVES = ("pwconv1", "pred_", "proj")


def param_sharding_rules(key: str, shape: tuple[int, ...], model_size: int) -> Optional[int]:
    """The dim of a state-dict leaf split over the ``model`` axis, or None
    (replicated): JAX's ``param_sharding_rules`` in the port's terms.  The
    output channels -- dim 0 of a ``Linear`` or ``Conv2d`` weight, and its
    bias -- of every leaf whose key names ``pwconv1``, ``pred_`` (the
    ``pred_dict`` heads) or ``proj``, where the axis's size divides them
    (the 14-way biome head stays whole at model 4)."""
    if (shape and model_size > 1 and shape[0] % model_size == 0
            and key.endswith((".weight", ".bias")) and any(k in key for k in SHARDED_LEAVES)):
        return 0
    return None


def _widths(model: torch.nn.Module) -> dict[str, int]:
    """The output channels of every ``Linear`` and ``Conv2d`` leaf of
    ``model``, by state-dict key (a module registered under several names,
    FCMAE's decoder, under each)."""
    out = {}
    for name, m in model.named_modules(remove_duplicate=False):
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            width = m.out_features if isinstance(m, torch.nn.Linear) else m.out_channels
            for leaf in ("weight", "bias"):
                if getattr(m, leaf) is not None:
                    out[f"{name}.{leaf}" if name else leaf] = width
    return out


def shard_keys(model: torch.nn.Module) -> set[str]:
    """The state-dict keys of ``model`` whose tensor holds a shard: dim 0
    shorter than the leaf's output channels (:func:`shard_params`)."""
    full = _widths(model)
    return {k for k, v in model.state_dict(keep_vars=True).items()
            if k in full and v.shape[0] != full[k]}


def _slice(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    return t.chunk(mesh.model, dim)[mesh.model_index].clone()


@torch.no_grad()
def shard_params(model: torch.nn.Module, group) -> torch.nn.Module:
    """Keep on this rank only its model index's contiguous slice of each
    leaf :func:`param_sharding_rules` splits (``model``'s leaves whole, as
    built or loaded), as GSPMD splits them, and give the grid's groups to
    the modules (:func:`set_process_group`); returns ``model``.  A
    ``model`` axis of 1 (or a process group) splits nothing."""
    mesh = as_mesh(group)
    set_process_group(model, mesh)
    for name, p in model.named_parameters():
        if param_sharding_rules(name, tuple(p.shape), mesh.model) is not None:
            p.data = _slice(p.data, mesh)
    return model


def _gather(t: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.model_group)
    return torch.cat(parts, dim)


def _map_opt_state(state: Mapping, dims: Mapping[str, Mapping[str, int]], fn) -> dict:
    """``state`` (``Optimizer.state_dict``) with ``fn(tensor, dim)`` applied
    to each tensor that ``dims`` (``Optimizer.state_split_dims``) names a
    split dim of; every other tensor (a replicated leaf's, a slot reduced
    over the split dim, NovoGrad's per-tensor norm) stays as it is."""
    out = dict(state)
    for key, per_name in state.items():
        if isinstance(per_name, Mapping):
            split = dims.get(key, {})
            out[key] = {n: fn(t, split[n]) if n in split else t for n, t in per_name.items()}
    return out


@torch.no_grad()
def gather_state(model: torch.nn.Module, opt, group) -> tuple[dict, Optional[dict]]:
    """The whole state of a model split over a grid and of its optimizer:
    ``model.state_dict()`` and ``opt.state_dict()`` with every shard
    gathered over the model group, the keys, shapes and values that a run
    at ``model`` 1 holds.  Every rank of a model group calls it."""
    mesh = as_mesh(group)
    sd = model.state_dict()
    if mesh.model == 1:
        return sd, (opt.state_dict() if opt is not None else None)
    split = shard_keys(model)
    sd = {k: _gather(v, mesh) if k in split else v for k, v in sd.items()}
    if opt is None:
        return sd, None
    return sd, _map_opt_state(opt.state_dict(), opt.state_split_dims(),
                              lambda t, dim: _gather(t, mesh, dim))


def shard_state(sd: Mapping[str, torch.Tensor], model: torch.nn.Module, group) -> dict:
    """A whole state dict of ``model``'s keys (as a run at ``model`` 1 saves
    it) cut to this rank's shards of the leaves ``model`` holds split."""
    mesh = as_mesh(group)
    split = shard_keys(model)
    return {k: _slice(torch.as_tensor(v), mesh) if k in split else v for k, v in sd.items()}


@torch.no_grad()
def place_state(model: torch.nn.Module, opt, group, model_sd: Mapping,
                opt_state: Optional[Mapping] = None) -> None:
    """Load a whole state (a checkpoint of any grid, :func:`gather_state`)
    into a model split over the grid and its optimizer: each split leaf,
    and each optimizer tensor that ``opt`` records as split (Adam's mu and
    nu, each family's own slots, Adafactor's along the dim each keeps, the
    accumulated gradient), as this rank's slice (JAX ``place_state``)."""
    mesh = as_mesh(group)
    model.load_state_dict(shard_state(model_sd, model, mesh))
    if opt is not None and opt_state is not None:
        opt.load_state_dict(_map_opt_state(opt_state, opt.state_split_dims(),
                                           lambda t, dim: _slice(t, mesh, dim)))

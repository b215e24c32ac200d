"""The port's tensor-parallel ``model`` axis (``mmearth_tpu_torch/parallel/mesh.py``)
on the CPU: four gloo ranks, spawned once for the module
(``tests/_torch_tp_worker.py``), as a (2, 2) and a (1, 4) grid, against
JAX's ``create_mesh(2, 2)`` + ``shard_params`` and its pure data mesh
(4, 1) on four devices of the 8-device simulation (``tests/conftest.py``)
from the same numpy weights, batches and masks, and against the port's
own one process.  JAX's (2, 2) mesh returns twice the gradient of every
depthwise conv kernel (see ``test_pretrain_steps_match_jax_mesh_2x2``), so
gradients and updates are held against its (4, 1) mesh, losses against
both.

Adafactor on the grid (``tests/_torch_tp_worker.py::leaves`` and
``adafactor_classifier``): leaves whose whole shape, not the shard's,
decides the factoring (optax's ``scale_by_factored_rms`` on the whole
leaves, one JAX device), the classifier at widths 16-128 (stage 3's
``pwconv1`` split and factored; the loss against JAX's (4, 1) mesh, the
rest against the port's one process), its ``.pth`` at (2, 2) and a (1, 4)
resume of the one-process file, and ``broadcast_state`` of its slots.

The model is ``tests/test_model_axis.py``'s mini FCMAE (32 px, patch 8,
depths 1/1/1/1, dims 8-64, decoder 32, ``sentinel2`` + ``biome`` heads):
at model 2 it splits every ``pwconv1``, ``proj`` and both heads; at model 4
the 14-way biome head stays whole.

Tolerances, as ``tests/test_torch_distributed.py`` holds a step: losses
within 1e-4 relative, gradients within 1e-3 of each tensor's largest
magnitude (both sides compute the same f32 math, the sums in other orders:
the column-parallel backward adds the ranks' parts of dx, JAX's
masked-dense encoder sums the zeros of the masked sites).  Params after
the optimizer within 1e-4 of each tensor's scale plus the gap between the
two sides' steps on their own gradients (``_close_updated``: Adam divides
by each gradient's own magnitude, so a near-zero gradient's ulps move its
step by up to the lr).  Port against port: bitwise where the arithmetic is
the same (a chained dispatch against single steps, the copies of a
replicated leaf), losses within 1e-5 relative.
"""
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from optax._src import factorized
import torch
import torch.multiprocessing as mp

from mmearth_tpu.checkpoints import torch_convert as jtc
from mmearth_tpu.configs import modalities as JM
from mmearth_tpu.losses import finetune as jloss
from mmearth_tpu.models import convnextv2 as jcnx
from mmearth_tpu.models import fcmae as jfc
from mmearth_tpu.parallel import mesh as jmesh
from mmearth_tpu.train import optim as joptim
from mmearth_tpu.train.finetune import make_finetune_step
from mmearth_tpu.train.step import TrainState
from mmearth_tpu_torch.checkpoints import orbax_io, pth_io
from mmearth_tpu_torch.checkpoints.convert import tree_leaves
from mmearth_tpu_torch.checkpoints.convert import from_jax_classifier, from_jax_fcmae
from mmearth_tpu_torch.configs import modalities as M
from mmearth_tpu_torch.data.synthetic import bench_batch, synthetic_batch
from mmearth_tpu_torch.losses.finetune import criterion_fn
from mmearth_tpu_torch.models import fcmae as tfc
from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
from mmearth_tpu_torch.models.unet import ConvNeXtV2Unet
from mmearth_tpu_torch.parallel import mesh as tmesh
from mmearth_tpu_torch.train.finetune import finetune_step
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train.optim import AdamW
from mmearth_tpu_torch.train.step import fold_in, pretrain_step

import _torch_tp_worker as worker
from _torch_parity import close, np_tree, random_mask

WORLD = 4
N = 8  # the global batch: 4 rows a data index at (2, 2)
DEPTHS, DIMS = (1, 1, 1, 1), (8, 16, 32, 64)
OUT = ("sentinel2", "biome")
KW = dict(img_size=32, patch_size=8, depths=DEPTHS, dims=DIMS, decoder_embed_dim=32,
          out_modalities={k: M.OUT_MODALITIES[k] for k in OUT})
RTOL, GRAD_RTOL, PORT_RTOL = 1e-4, 1e-3, 1e-5
LR, WD, BETAS = 1e-3, 0.05, (0.9, 0.95)
CLS_KW = dict(patch_size=8, img_size=32, in_chans=12, num_classes=10, depths=DEPTHS, dims=DIMS)
CLS_LR = 1e-2
UNET_LR = 1e-3
NORM_FAMILIES = ("lamb", "novograd")  # the families whose update takes a norm a leaf
UNET_KW = dict(patch_size=8, img_size=32, in_chans=12, num_classes=4, depths=DEPTHS,
               dims=DIMS, drop_path_rate=0.3)
# the Adafactor classifier: stage 3's pwconv1 (flax (128, 512)) is factored
ADA_KW = {**CLS_KW, "dims": (16, 32, 64, 128)}
LEAF_LR, LEAF_RTOL = 1e-2, 1e-5
# the Adafactor leaves (``worker.leaf_module``): flax name and kernel shape
LEAF_SHAPES = {"a": ("pwconv1", (128, 512)), "b": ("proj", (512, 256)),
               "c": ("pred_x", (256, 384)), "d": ("pred_y", (1, 1, 128, 256)),
               "e": ("fc", (160, 160))}
# which of their slots are a shard at (2, 2): v_col where the split dim
# is optax's d0 (it keeps it), v_row where it is d1, v of an unfactored split leaf
LEAF_SPLIT = {"v_row": {"b.proj.weight"},
              "v_col": {"a.pwconv1.weight", "c.pred_x.weight", "d.pred_y.weight"},
              "v": {f"{k}.bias" for k in ("a.pwconv1", "b.proj", "c.pred_x", "d.pred_y")}}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _random_grn(model, rng):
    """GRN affines made non-trivial (they init to zero, which hides GRN bugs)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".grn." in name:
                p.copy_(torch.from_numpy(0.5 * rng.normal(size=p.shape).astype(np.float32)))
    return model


def _flax_leaves(rng) -> dict:
    return {a: {m: {"kernel": (0.1 * rng.normal(size=shape)).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)}}
            for a, (m, shape) in LEAF_SHAPES.items()}


def _port_leaves(tree) -> dict:
    """A flax tree of the leaves as the port's state dict: a Linear's kernel
    transposed, a conv's HWIO as OIHW."""
    out = {}
    for a, (m, _) in LEAF_SHAPES.items():
        k = np.asarray(tree[a][m]["kernel"])
        k = k.T if k.ndim == 2 else k.transpose(3, 2, 0, 1)
        out[f"{a}.{m}.weight"] = torch.from_numpy(np.ascontiguousarray(k))
        out[f"{a}.{m}.bias"] = torch.from_numpy(np.array(tree[a][m]["bias"]))
    return out


def _inputs(rng, root):
    """The port's weights (GRN affines and uncertainty weights made
    non-trivial), the batches and masks, the classifier's and the U-Net's,
    the Adafactor leaves and their gradients; and JAX's two classifiers and
    the leaves and gradients as flax trees."""
    tm = _random_grn(tfc.FCMAE(**KW).init_weights(torch.Generator().manual_seed(0)), rng)
    with torch.no_grad():
        tm.loss_fn.log_vars.copy_(torch.linspace(-0.5, 0.5, 2))
    keep = int(16 * (1 - 0.6))
    pick = lambda b: {k: v for k, v in b.items() if k in OUT}  # noqa: E731
    cls = jcnx.ConvNeXtV2(**CLS_KW, sparse=False)
    tcls = ConvNeXtV2(**CLS_KW, sparse=False)
    tcls.init_weights(torch.Generator().manual_seed(1))
    _random_grn(tcls, rng)
    unet = ConvNeXtV2Unet(**UNET_KW)
    unet.init_weights(torch.Generator().manual_seed(2))
    _random_grn(unet, rng)
    ada = ConvNeXtV2(**ADA_KW, sparse=False)
    ada.init_weights(torch.Generator().manual_seed(6))
    leaf_rng = np.random.default_rng(1)
    _random_grn(ada, leaf_rng)
    flax_leaves = _flax_leaves(leaf_rng)
    flax_grads = [_flax_leaves(leaf_rng) for _ in range(6)]
    jax_in = {"cls": cls, "ada": jcnx.ConvNeXtV2(**ADA_KW, sparse=False), "leaves": flax_leaves,
              "leaf_grads": flax_grads}
    return dict(kw=KW, sd=tm.state_dict(), batch=pick(synthetic_batch(N, 32, seed=3)),
                batch2=pick(synthetic_batch(N, 32, seed=4)),
                mask=random_mask(rng, N, 16, keep), mask2=random_mask(rng, N, 16, keep),
                raw40=pick(bench_batch(N, 40, seed=5)), lr=LR, wd=WD, betas=BETAS,
                cls_kw=CLS_KW, cls_sd=tcls.state_dict(), cls_lr=CLS_LR,
                cls_x=rng.normal(size=(N, 32, 32, 12)).astype(np.float32),
                cls_y=rng.integers(0, 10, size=(N,)).astype(np.int64),
                unet_kw=UNET_KW, unet_sd=unet.state_dict(), unet_lr=UNET_LR,
                seg_x=rng.normal(size=(N, 32, 32, 12)).astype(np.float32),
                seg_y=rng.integers(0, 4, size=(N, 32, 32)).astype(np.int64),
                pth1=str(root / "one" / "checkpoint-0.pth"),
                orbax1=str(root / "one" / "checkpoints" / "0"),
                leaf_sd=_port_leaves(flax_leaves), leaf_grads=[_port_leaves(g) for g in flax_grads],
                leaf_lr=LEAF_LR, ada_kw=ADA_KW, ada_sd=ada.state_dict(),
                ada_x2=leaf_rng.normal(size=(N, 32, 32, 12)).astype(np.float32),
                ada_y2=leaf_rng.integers(0, 10, size=(N,)).astype(np.int64),
                ada_pth1=str(root / "ada_one" / "checkpoint-0.pth")), jax_in


def _grads(model) -> dict:
    """Each param's gradient after a step (zeros where it took none, as the
    U-Net's unused final norm)."""
    return {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
            for k, p in model.named_parameters()}


def _one_process(inp, root) -> dict:
    """The port at ``model`` 1 in this process on the global batch: the two
    explicit-mask steps (each checkpointed), the two drawn steps, and the
    U-Net step; each with its losses, params and each step's gradients."""
    model = tfc.FCMAE(**KW, block_impl="wholeblock")
    model.load_state_dict(inp["sd"])
    opt = AdamW(model.named_parameters(), lambda c: LR, WD, BETAS)
    gen = torch.Generator().manual_seed(0)
    losses, grads = [], []
    for i, (b, m) in enumerate(worker.STEPS):
        batch = {k: torch.from_numpy(v) for k, v in inp[b].items()}
        losses.append(float(pretrain_step(model, opt, batch, i, gen, random_crop=False,
                                          mask=torch.from_numpy(inp[m]))["loss"]))
        grads.append(_grads(model))
        pth_io.save_checkpoint(root / "one", i, model, opt, {}, keep=0)
        orbax_io.save(root / "one", i, model, opt, {}, keep=0)
    out = {"losses": losses, "grads": grads,
           "sd": {k: v.clone() for k, v in model.state_dict().items()}}
    model = tfc.FCMAE(**KW, block_impl="wholeblock")
    model.load_state_dict(inp["sd"])
    opt = AdamW(model.named_parameters(), lambda c: LR, WD, BETAS)
    gen = torch.Generator().manual_seed(5)
    raw = {k: torch.from_numpy(v) for k, v in inp["raw40"].items()}
    losses, grads = [], []
    for i in range(2):
        losses.append(float(pretrain_step(model, opt, raw, i, gen)["loss"]))
        grads.append(_grads(model))
    out["drawn"] = {"losses": losses, "grads": grads, "sd": model.state_dict()}
    unet = ConvNeXtV2Unet(**UNET_KW)
    unet.load_state_dict(inp["unet_sd"])
    opt = AdamW(unet.named_parameters(), lambda c: UNET_LR)
    batch = {"input": torch.from_numpy(inp["seg_x"]), "label": torch.from_numpy(inp["seg_y"])}
    loss = finetune_step(unet, opt, batch, criterion_fn("m-cashew-plant", 0.0),
                         fold_in(torch.Generator().manual_seed(3), 0))
    out["unet"] = {"loss": float(loss), "grads": [_grads(unet)], "sd": unet.state_dict()}
    out["classifier"] = {}
    for family in NORM_FAMILIES:
        model, loss = worker.classifier_step(inp, None, family)
        out["classifier"][family] = {"loss": loss, "grads": [_grads(model)],
                                     "sd": model.state_dict()}
    out["adafactor"] = worker.adafactor_classifier(inp, None, save=root / "ada_one")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one-process run first (its checkpoint is a rank's input), then
    the four ranks, which run while JAX computes the references here."""
    rng = np.random.default_rng(0)
    root = tmp_path_factory.mktemp("torch_tp")
    inp, jax_in = _inputs(rng, root)
    one = _one_process(inp, root)
    torch.save(inp, root / "inputs.pt")
    ctx = mp.spawn(worker.run, args=(WORLD, _free_port(), str(root)), nprocs=WORLD, join=False)
    try:
        refs = _jax_refs(inp, jax_in)
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return inp, refs, one, ranks, root


def _factored_state(state):
    """The ``scale_by_factored_rms`` state inside an optax chain's state."""
    if hasattr(state, "v_row"):
        return state
    for s in state if isinstance(state, tuple) else ():
        found = _factored_state(s)
        if found is not None:
            return found
    return None


def _port_slot(a: np.ndarray, flax_shape: tuple, slot: str) -> torch.Tensor:
    """An optax Adafactor slot of a leaf of ``flax_shape`` in the port's
    layout: v_row without optax's d0, v_col without its d1, a param-shaped
    v, each remaining axis carried as the param's; a (1,) placeholder as
    it is."""
    dims = factorized._factored_dims(flax_shape, True, 128)
    if (dims is None) != (slot == "v"):
        return torch.from_numpy(np.array(a))
    nd = len(flax_shape)
    drop = None if dims is None else (dims[1] if slot == "v_row" else dims[0])
    kept = [f for f in range(nd) if f != drop]
    order = [f for f in {1: (0,), 2: (1, 0), 4: (3, 2, 0, 1)}[nd] if f != drop]
    return torch.from_numpy(np.array(np.transpose(a, [kept.index(f) for f in order])))


def _leaf_refs(jax_in) -> dict:
    """optax's Adafactor (``make_finetune_optimizer``, weight decay 0.3) on
    the whole leaves, by update_freq: three updates' params and slots, in
    the port's layout."""
    out = {}
    for update_freq in (1, 2):
        params = jax.tree_util.tree_map(jnp.asarray, jax_in["leaves"])
        tx = joptim.make_finetune_optimizer(params, lambda c: LEAF_LR, 0.3, opt="adafactor",
                                            update_freq=update_freq)
        state, update = tx.init(params), jax.jit(tx.update)
        for g in jax_in["leaf_grads"][:3 * update_freq]:
            upd, state = update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
            params = optax.apply_updates(params, upd)
        fs = _factored_state(state)
        slots = {}
        for slot in worker.ADA_SLOTS:
            tree = np_tree(getattr(fs, slot))
            slots[slot] = {f"{a}.{m}.{'weight' if leaf == 'kernel' else 'bias'}":
                           _port_slot(tree[a][m][leaf], jax_in["leaves"][a][m][leaf].shape, slot)
                           for a, (m, _) in LEAF_SHAPES.items() for leaf in ("kernel", "bias")}
        out[update_freq] = {"sd": _port_leaves(np_tree(params)), "slots": slots}
    return out


def _jax_refs(inp, jax_in) -> dict:
    """JAX on its (2, 2) mesh and on the pure data mesh (4, 1) of the same
    four devices: the mini FCMAE's two AdamW steps (losses, each step's
    gradients, params); on the (4, 1) mesh the classifier's finetune step
    (loss, gradients, params) and the Adafactor classifier's loss; and
    optax's Adafactor on the whole leaves."""
    jcls = jax_in["cls"]
    meshes = {"2x2": jmesh.create_mesh(data=2, model=2, devices=jax.devices()[:WORLD]),
              "4x1": jmesh.create_mesh(data=4, model=1, devices=jax.devices()[:WORLD])}
    params0 = jax.tree_util.tree_map(jnp.asarray, jtc.torch_fcmae_to_flax(
        {k: v.numpy() for k, v in inp["sd"].items()}, DEPTHS, OUT))
    jm = jfc.FCMAE(**{**KW, "out_modalities": {k: JM.OUT_MODALITIES[k] for k in OUT}},
                   inp_modalities=JM.INP_MODALITIES)
    tx = joptim.make_pretrain_optimizer(params0, lambda c: LR, WD, BETAS)

    @jax.jit
    def step(p, state, b, m):
        (loss, _), g = jax.value_and_grad(
            lambda q: (lambda o: (o[0], o[3]))(jm.apply({"params": q}, b, mask=m)),
            has_aux=True)(p)
        upd, state = tx.update(g, state, p)
        return optax.apply_updates(p, upd), state, loss, g

    refs = {}
    for name, mesh in meshes.items():
        sharded = lambda t, mesh=mesh: jax.device_put(t, jmesh.batch_sharding(mesh))  # noqa: E731
        params = jmesh.shard_params(params0, mesh)
        state, losses, grads = tx.init(params), [], []
        for b, m in worker.STEPS:
            batch = jfc.zero_nan_inputs({k: jnp.asarray(v) for k, v in inp[b].items()})
            params, state, loss, g = step(params, state, sharded(batch),
                                          sharded(jnp.asarray(inp[m])))
            losses.append(float(loss))
            grads.append(from_jax_fcmae(np_tree(g), DEPTHS, OUT))
        refs[name] = {"losses": losses, "grads": grads,
                      "sd": from_jax_fcmae(np_tree(params), DEPTHS, OUT)}
    mesh = meshes["4x1"]
    sharded = lambda t: jax.device_put(t, jmesh.batch_sharding(mesh))  # noqa: E731
    cp = jmesh.shard_params(jax.tree_util.tree_map(jnp.asarray, jtc.torch_encoder_to_flax(
        {k: v.numpy() for k, v in inp["cls_sd"].items()}, DEPTHS, include_head=True)), mesh)
    criterion = jloss.criterion_fn("m-eurosat", 0.2)
    ctx = joptim.make_finetune_optimizer(cp, lambda c: CLS_LR, 0.3, (0.9, 0.999), 0.9,
                                         depths=DEPTHS, clip_grad=1.0)
    xy = sharded({"input": jnp.asarray(inp["cls_x"]),
                  "label": jnp.asarray(inp["cls_y"].astype(np.int32))})
    ft_state, metrics = jax.jit(make_finetune_step(jcls, criterion, False))(
        TrainState.create(cp, ctx), xy, jax.random.PRNGKey(0))
    g = jax.jit(jax.grad(lambda q, x, y: criterion(jcls.apply({"params": q}, x), y)))(
        cp, xy["input"], xy["label"])
    refs["classifier"] = {"loss": float(metrics["loss"]),
                          "grads": [from_jax_classifier(np_tree(g), DEPTHS)],
                          "sd": from_jax_classifier(np_tree(ft_state.params), DEPTHS)}
    ap = jmesh.shard_params(jax.tree_util.tree_map(jnp.asarray, jtc.torch_encoder_to_flax(
        {k: v.numpy() for k, v in inp["ada_sd"].items()}, DEPTHS, include_head=True)), mesh)
    atx = joptim.make_finetune_optimizer(ap, lambda c: CLS_LR, 0.3, (0.9, 0.999), 0.9,
                                         depths=DEPTHS, clip_grad=1.0, opt="adafactor")
    _, metrics = jax.jit(make_finetune_step(jax_in["ada"], criterion, False))(
        TrainState.create(ap, atx), xy, jax.random.PRNGKey(0))
    refs["adafactor_classifier"] = {"loss": float(metrics["loss"])}
    refs["leaves"] = _leaf_refs(jax_in)
    return refs


def _close_sd(got, ref, what, rtol=RTOL):
    assert got, what
    for k, v in got.items():
        close(v.numpy(), ref[k].reshape(v.shape).numpy(), f"{what} {k}", rtol)


def _adam_moves(grads, lr, betas, eps=1e-8):
    """Each element's total Adam displacement (before lr scales and decay)
    over the steps of ``grads``, in f64."""
    b1, b2 = betas
    mu = nu = move = 0.0
    for t, g in enumerate(grads, 1):
        mu, nu = b1 * mu + (1 - b1) * g, b2 * nu + (1 - b2) * g * g
        move = move + lr * (mu / (1 - b1 ** t)) / (np.sqrt(nu / (1 - b2 ** t)) + eps)
    return move


def _jax_factored(shape):
    """optax's factored dims (d1, d0) of a leaf of the port's ``shape``, as
    the port's axes, or None."""
    axes = {2: (1, 0), 4: (2, 3, 1, 0)}.get(len(shape), tuple(range(len(shape))))
    dims = factorized._factored_dims(tuple(shape[a] for a in axes), True, 128)
    return None if dims is None else (axes[dims[0]], axes[dims[1]])


def _adafactor_moves(grads, lr, dims, decay_rate=0.8, eps=1e-30):
    """Each element's total Adafactor displacement over the steps of
    ``grads`` (whole leaves, the port's layout), in f64: optax's factored
    statistics over ``dims`` (d1, d0), or the per-element ones where None,
    whose step is ~ sign(g) * lr as Adam's first is."""
    v_row = v_col = v = move = 0.0
    for t, g in enumerate(grads, 1):
        decay = 1.0 - t ** -decay_rate
        sq = g * g + eps
        if dims is None:
            v = decay * v + (1 - decay) * sq
            move = move + lr * g / np.sqrt(v)
            continue
        d1, d0 = dims
        v_row = decay * v_row + (1 - decay) * sq.mean(axis=d0)
        v_col = decay * v_col + (1 - decay) * sq.mean(axis=d1)
        row = v_row / v_row.mean(axis=d1 - 1 if d1 > d0 else d1, keepdims=True)
        move = move + lr * g / np.sqrt(np.expand_dims(row, d0) * np.expand_dims(v_col, d1))
    return move


def _close_updated(got, ref, got_grads, ref_grads, what, lr=LR, betas=BETAS, clip=None,
                   start=None):
    """Params after AdamW steps against a reference's: each within 1e-4 of
    its tensor's scale plus how far apart Adam's steps on the two sides'
    own gradients (held to each other separately) put it.  Adam divides by
    the gradient's own magnitude, so where a gradient lies near its sums'
    f32 noise or near Adam's eps, a difference far inside the gradients'
    tolerance moves its step anywhere in [-lr, lr].  ``clip``: the steps'
    gradients clipped by their global norm first.  With ``start`` (the
    params before the steps) the steps are Adafactor's, the finetune
    weight decay 0.3 added to the gradients of the decayed params."""
    assert got, what
    # the port's own gradients are by param name: a state dict's other
    # names of FCMAE's shared decoder hold the same tensors
    got = {k: v for k, v in got.items()
           if k in got_grads[0] or not k.startswith("decoder_dict.")}

    def scale(g):
        if clip is None:
            return 1.0
        return min(1.0, clip / float(np.sqrt(sum(float((t.double() ** 2).sum())
                                                 for t in g.values()))))

    def moves(grads, k, shape):
        steps = [scale(g) * g[k].reshape(shape).double().numpy() for g in grads]
        if start is None:
            return _adam_moves(steps, lr, betas)
        if len(shape) > 1 and not k.endswith(("bias", "gamma", "beta")):
            steps = [s + 0.3 * start[k].double().numpy() for s in steps]
        return _adafactor_moves(steps, lr, _jax_factored(shape))

    for k, v in got.items():
        r = ref[k].reshape(v.shape).numpy()
        spread = np.abs(moves(got_grads, k, v.shape) - moves(ref_grads, k, v.shape))
        tol = RTOL * max(np.abs(r).max(), 1e-6) + spread
        bad = np.abs(v.numpy() - r) > tol
        assert not bad.any(), (f"{what} {k}: {int(bad.sum())} of {bad.size} elements off, "
                               f"worst {float(np.abs(v.numpy() - r).max())}")


def _close_lamb(got, ref, start, got_grads, ref_grads):
    """LAMB's one step (the first: Adam's direction g / (|g| + eps)) against
    a reference's: within 1e-4 of each tensor's scale plus the lr times the
    leaf's trust ratio (bounded by |p| over the norm of the reference's
    direction) times how far apart the two sides' gradients put that
    direction, elementwise."""
    for k, v in got.items():
        r = ref[k].reshape(v.shape).numpy()
        da, db = (_adam_moves([g[k].reshape(v.shape).double().numpy()], 1.0, (0.9, 0.999))
                  for g in (got_grads, ref_grads))
        ratio = float(np.linalg.norm(start[k].double().numpy())) / max(np.linalg.norm(db),
                                                                        1e-30)
        tol = RTOL * max(np.abs(r).max(), 1e-6) + CLS_LR * ratio * np.abs(da - db)
        bad = np.abs(v.numpy() - r) > tol
        assert not bad.any(), f"{k}: {int(bad.sum())} of {bad.size} elements off"


def _jax_split_keys(sd, model_size):
    """The port's keys of the leaves JAX's rule splits, mapped through
    ``from_jax_fcmae``: each JAX leaf marked 1 where split, 0 where not."""
    tree = jtc.torch_fcmae_to_flax({k: v.numpy() for k, v in sd.items()}, (2, 2, 6, 2),
                                   list(JM.OUT_MODALITIES))

    def mark(path, leaf):
        path_str = "/".join(str(getattr(p, "key", p)) for p in path)
        spec = jmesh.param_sharding_rules(path_str, np.shape(leaf), model_size)
        return np.full(np.shape(leaf), float(spec != jax.sharding.PartitionSpec()), np.float32)

    marked = from_jax_fcmae(jax.tree_util.tree_map_with_path(mark, tree), (2, 2, 6, 2),
                            list(JM.OUT_MODALITIES))
    return {k for k, v in marked.items() if bool(v.all())}, marked


@pytest.mark.parametrize("model_size", [1, 2, 4])
def test_rule_splits_the_leaves_jax_splits(model_size):
    """At atto widths with every output modality, the port's rule on the
    state-dict keys splits exactly the leaves JAX's rule splits (mapped
    through ``from_jax_fcmae``), on dim 0; the 14-way biome head is split at
    model 2 and whole at 4, the 846-way eco_region head likewise."""
    sd = tfc.FCMAE(img_size=56, patch_size=8, depths=(2, 2, 6, 2),
                   dims=(40, 80, 160, 320)).state_dict()
    want, marked = _jax_split_keys(sd, model_size)
    assert all(bool(v.all()) or not bool(v.any()) for v in marked.values())
    got = {k for k, v in sd.items()
           if tmesh.param_sharding_rules(k, tuple(v.shape), model_size) == 0}
    assert got == want
    assert all(tmesh.param_sharding_rules(k, tuple(v.shape), model_size) in (0, None)
               for k, v in sd.items())
    for head in ("biome", "eco_region"):
        assert (f"pred_dict.{head}.weight" in got) == (model_size == 2)
    assert bool(got) == (model_size > 1)


@pytest.mark.parametrize("case", worker.CASES, ids=lambda c: "-".join(c))
def test_pretrain_steps_match_jax_mesh_2x2(runs, case):
    """Two AdamW steps at (2, 2): the composed tail (``auto``: column-parallel
    products), ``wholeblock`` (the spill-g phases fed the gathered W1),
    masked-dense ``fused`` (the masked kernels fed it), ``remat`` (the
    column-parallel tail recomputed under ``torch.utils.checkpoint``, its
    gather repeated) and ``folded`` (W1 gathered): each rank's losses are
    those of JAX's (2, 2) mesh, and its gradients and the gathered params
    (``pwconv1``'s kernel among them) after the two steps those of JAX's
    pure data mesh (4, 1) on the same devices.  JAX's own (2, 2) mesh
    returns twice the gradient of every depthwise conv kernel (the stem's
    and each Block's ``dwconv``: the model axis's size) against its (4, 1)
    mesh and one device, here and in the classifier; AdamW's update is
    invariant to that scale, so its params after the steps still agree, but
    its gradients do not."""
    inp, refs, one, ranks, root = runs
    ref = refs["4x1"]
    np.testing.assert_allclose(refs["2x2"]["losses"], ref["losses"], rtol=RTOL)
    block_impl = case[1]
    for i, r in enumerate(ranks):
        assert r["grid22"] == (i // 2, i % 2, 2, 2)
        got = r["pretrain"][("2x2", block_impl)]
        close(np.array(got["losses"]), np.array(refs["2x2"]["losses"]), "losses", RTOL)
        for step, g in enumerate(got["grads"]):
            _close_sd(g, ref["grads"][step], f"step {step} grad", GRAD_RTOL)
        _close_updated(got["whole"], ref["sd"], got["grads"], ref["grads"], "param")
        assert {k for k in got["split"] if "pwconv1" in k} >= {
            f"encoder.stages.{i}.0.pwconv1.weight" for i in range(4)}


def test_grid_1x4_keeps_the_biome_head_whole(runs):
    """(1, 4): the 14-way biome head whole on every rank, the sentinel2
    head (768 channels) and the encoder's pwconv1 split in four; the
    losses, gradients and params are JAX's."""
    inp, refs, one, ranks, root = runs
    for i, r in enumerate(ranks):
        assert r["grid14"] == (0, i, 1, 4)
        got = r["pretrain"][("1x4", "wholeblock")]
        assert got["shapes"]["pred_dict.biome.weight"] == (14, 32)
        assert got["shapes"]["pred_dict.sentinel2.weight"] == (768 // 4, 32, 1, 1)
        assert got["shapes"]["encoder.stages.0.0.pwconv1.weight"] == (32 // 4, 8)
        assert "pred_dict.biome.weight" not in got["split"]
        close(np.array(got["losses"]), np.array(refs["2x2"]["losses"]), "losses", RTOL)
        for step, g in enumerate(got["grads"]):
            _close_sd(g, refs["4x1"]["grads"][step], f"step {step} grad", GRAD_RTOL)
        _close_updated(got["whole"], refs["4x1"]["sd"], got["grads"], refs["4x1"]["grads"],
                       "param")


def test_chained_step_on_the_grid_equals_single_steps(runs):
    """Drawn crops and masks at (2, 2): a ChainedStep of two trains as two
    single steps do, bit for bit, which train as one process does on the
    whole batch."""
    inp, refs, one, ranks, root = runs
    for r in ranks:
        single, ch = r["chained"]["single"], r["chained"]["chained"]
        np.testing.assert_array_equal(ch["losses"], single["losses"])
        for k, v in single["own"].items():
            torch.testing.assert_close(ch["own"][k], v, rtol=0, atol=0, msg=k)
        close(np.array(single["losses"]), np.array(one["drawn"]["losses"]), "losses", PORT_RTOL)
        _close_updated(single["whole"], one["drawn"]["sd"], single["grads"],
                       one["drawn"]["grads"], "param")


def test_classifier_step_matches_jax(runs):
    """The dense classifier's step at (2, 2) with layer decay 0.9 and clip
    1.0 (its Blocks' pwconv1 split): the loss and the params are those of
    JAX's ``make_finetune_step`` on its pure data mesh (4, 1) (its (2, 2)
    mesh doubles the depthwise kernels' gradients, which the clip's global
    norm then sees)."""
    inp, refs, one, ranks, root = runs
    ref = refs["classifier"]
    for r in ranks:
        got = r["classifier"]["adamw"]
        assert "stages.0.0.pwconv1.weight" in got["split"] and "head.weight" not in got["split"]
        close(got["loss"], ref["loss"], "loss", RTOL)
        _close_updated(got["whole"], ref["sd"], got["grads"], ref["grads"], "param", CLS_LR,
                       (0.9, 0.999), clip=1.0)


def test_unet_step_on_the_grid_equals_one_process(runs):
    """A U-Net step with drop path 0.3 at (2, 2), its encoder Blocks'
    pwconv1 split: the loss and the params are one process's."""
    inp, refs, one, ranks, root = runs
    for r in ranks:
        got = r["unet"]
        assert "stages.0.0.pwconv1.weight" in got["split"]
        close(got["loss"], one["unet"]["loss"], "loss", PORT_RTOL)
        _close_updated(got["whole"], one["unet"]["sd"], got["grads"], one["unet"]["grads"],
                       "param", UNET_LR)


@pytest.mark.parametrize("family", NORM_FAMILIES)
def test_norm_families_count_each_element_once(runs, family):
    """The classifier's step at (2, 2) under LAMB (a trust ratio of two
    norms a leaf) and NovoGrad (a gradient norm a leaf), with clip 1.0:
    the norms of split leaves summed over the model group, so the loss,
    gradients and params are one process's.  NovoGrad's step divides by the
    leaf's norm and is held at 1e-4 of scale; LAMB's Adam part divides by
    each element's own gradient (see ``_close_lamb``)."""
    inp, refs, one, ranks, root = runs
    want = one["classifier"][family]
    for r in ranks:
        got = r["classifier"][family]
        assert "stages.0.0.pwconv1.weight" in got["split"]
        close(got["loss"], want["loss"], "loss", PORT_RTOL)
        _close_sd(got["grads"][0], want["grads"][0], "grad", GRAD_RTOL)
        if family == "novograd":
            _close_sd(got["whole"], want["sd"], "param")
        else:
            _close_lamb(got["whole"], want["sd"], inp["cls_sd"], got["grads"][0],
                        want["grads"][0])


def test_checkpoint_at_2x2_is_the_one_process_file_and_resumes_it(runs):
    """The ``.pth`` rank 0 saved at (2, 2) holds the keys and shapes of the
    one-process file, model and optimizer alike, and its values within the
    step's tolerance; (2, 2) resumed from the one-process file after its
    first step continues that run."""
    inp, refs, one, ranks, root = runs
    grid = pth_io.load(root / "ckpt22" / "checkpoint-1.pth")
    flat = pth_io.load(root / "one" / "checkpoint-1.pth")
    assert grid["model"].keys() == flat["model"].keys()
    for k, v in flat["model"].items():
        assert grid["model"][k].shape == v.shape, k
    _close_updated(grid["model"], flat["model"],
                   ranks[0]["pretrain"][("2x2", "wholeblock")]["grads"], one["grads"],
                   "saved param")
    assert grid["optimizer"].keys() == flat["optimizer"].keys()
    for slot in ("mu", "nu"):
        assert grid["optimizer"][slot].keys() == flat["optimizer"][slot].keys()
        for k, v in flat["optimizer"][slot].items():
            assert grid["optimizer"][slot][k].shape == v.shape, (slot, k)
    for r in ranks:
        res = r["resume"]
        assert (res["epoch"], res["count"]) == (0, 2)
        close(res["losses"][0], one["losses"][1], "loss", PORT_RTOL)
        _close_updated(res["whole"], one["sd"], one["grads"][:1] + res["grads"], one["grads"],
                       "resumed param")


def test_orbax_step_restores_onto_2x2_and_rank_0_writes_it_back(runs):
    """The one-process run's Orbax step after its first step
    (``orbax_io.save``) restored onto the (2, 2) grid (``orbax_io.restore``
    with the grid): every rank's whole state, model and optimizer, is the
    one-process state bit for bit, and its next step's loss is the one the
    ``.pth`` resume gives; what rank 0 writes back from the grid
    (``gather_state``, ``save(whole=...)``) is the one-process write leaf
    for leaf, bit for bit."""
    inp, refs, one, ranks, root = runs
    flat = pth_io.load(inp["pth1"])
    for r in ranks:
        got = r["orbax"]
        assert (got["epoch"], got["count"], got["mini_step"]) == (0, 1, 0)
        assert got["whole"].keys() == flat["model"].keys()
        assert all(torch.equal(got["whole"][k], v) for k, v in flat["model"].items())
        for slot in ("mu", "nu"):
            assert all(torch.equal(got["opt"][slot][k], v)
                       for k, v in flat["optimizer"][slot].items())
        assert got["losses"] == r["resume"]["losses"]
    mine = dict(tree_leaves(orbax_io.load_tree(root / "orbax22" / "checkpoints" / "0")))
    theirs = dict(tree_leaves(orbax_io.load_tree(inp["orbax1"])))
    assert mine.keys() == theirs.keys()
    for k, v in theirs.items():
        assert (v is None and mine[k] is None) or (
            np.asarray(v).dtype == np.asarray(mine[k]).dtype
            and np.asarray(v).tobytes() == np.asarray(mine[k]).tobytes()), k


def test_replicated_leaves_agree_and_broadcast_keeps_each_shard(runs):
    """After the (2, 2) steps every replicated leaf is bit-identical on the
    four ranks and every shard on the two ranks of its data group;
    ``broadcast_state`` sends the replicated leaves from global rank 0 and
    each shard (param and Adam mu) from data index 0 of its data group."""
    inp, refs, one, ranks, root = runs
    for _, block_impl in worker.CASES:
        got = [r["pretrain"][("2x2", block_impl)] for r in ranks]
        split = got[0]["split"]
        for k, v in got[0]["own"].items():
            peers = range(1, 4) if k not in split else (2,)
            for i in peers:
                torch.testing.assert_close(got[i]["own"][k], v, rtol=0, atol=0, msg=k)
            if k in split:
                torch.testing.assert_close(got[3]["own"][k], got[1]["own"][k], rtol=0, atol=0)
    sd = inp["sd"]
    split = ranks[0]["pretrain"][("2x2", "wholeblock")]["split"]
    for i, r in enumerate(ranks):
        m = i % 2
        for k, v in r["broadcast"]["own"].items():
            want = sd[k].chunk(2)[m] + m if k in split else sd[k]
            torch.testing.assert_close(v, want, rtol=0, atol=0, msg=k)
            mu = r["broadcast"]["mu"][k]
            torch.testing.assert_close(mu, torch.full_like(mu, m if k in split else 0),
                                       rtol=0, atol=0, msg=k)


def test_create_mesh_w_by_1_keeps_the_data_axis_calls(runs):
    """``create_mesh(4, 1, group)`` makes no group, its data group is the
    group, and the gradient average and the broadcast make the calls, with
    the same sources and groups, that the plain group makes."""
    inp, refs, one, ranks, root = runs
    for r in ranks:
        c = r["calls"]
        assert c["grid_groups"] == (True, True, None)
        assert c["grid"] == c["group"]
        assert not any(name == "new_group" for name, _, _ in c["grid"])
        assert [x for x in c["grid"] if x[0] == "all_reduce"] == [("all_reduce", None, True)]


def test_dryrun_multichip_on_four_ranks(runs):
    """``dryrun_multichip`` through the four gloo ranks: a (2, 2) grid whose
    flagship loss equals the pure data grid's (checked inside, 1e-4), the
    same on every rank, a chained dispatch and a finetune step, finite."""
    inp, refs, one, ranks, root = runs
    first = ranks[0]["dryrun"]
    assert first["mesh"] == (2, 2)
    for r in ranks:
        d = r["dryrun"]
        close(d["loss"], first["loss"], "loss", PORT_RTOL)
        close(d["dp_loss"], d["loss"], "pure data grid loss", RTOL)
        assert len(d["chained"]) == 2 and np.isfinite(d["chained"]).all()
        assert np.isfinite(d["finetune_loss"])


@pytest.mark.parametrize("case", worker.LEAF_CASES, ids=lambda c: f"{c[0]}-update_freq{c[1]}")
def test_adafactor_leaves_match_optax_on_the_whole_leaves(runs, case):
    """Three Adafactor updates (weight decay 0.3; ``update_freq`` 2 averages
    two micro-steps an update) of leaves split on optax's d0 (``pwconv1``)
    and on its d1 (``proj``), a 1x1 conv, the biases and a replicated leaf,
    at (2, 2) and (1, 4): the gathered params and v_row/v_col/v are optax's
    on the whole leaves within 1e-5 of scale.  At (1, 4) the (256, 384) and
    the conv leaf are factored as wholes though their shards alone are not."""
    inp, refs, one, ranks, root = runs
    ref = refs["leaves"][case[1]]
    for r in ranks:
        got = r["adafactor"]["leaves"][case]
        assert got["count"] == 3
        split = {k for k in got["split"] if k.endswith(".weight")}
        assert split == {"a.pwconv1.weight", "b.proj.weight", "c.pred_x.weight",
                         "d.pred_y.weight"}
        assert all(got["factored"][k] for k in [*split, "e.fc.weight"])
        if case[0] == "1x4":
            assert not got["shard_factored"]["c.pred_x.weight"]
            assert not got["shard_factored"]["d.pred_y.weight"]
        for k, v in got["sd"].items():
            close(v.numpy(), ref["sd"][k].numpy(), f"param {k}", LEAF_RTOL)
        for slot in worker.ADA_SLOTS:
            assert got["opt"][slot].keys() == ref["slots"][slot].keys()
            for k, want in ref["slots"][slot].items():
                v = got["opt"][slot][k]
                assert v.shape == want.shape, (slot, k)
                close(v.numpy(), want.numpy(), f"{slot} {k}", LEAF_RTOL)


def test_adafactor_classifier_step_matches_one_process(runs):
    """The classifier at widths 16-128 under Adafactor (layer decay 0.9,
    weight decay 0.3, clip 1.0) at (2, 2), stage 3's ``pwconv1`` split and
    factored: the first step's loss is JAX's on its (4, 1) mesh; each of two
    steps' losses, gradients, params (within 1e-4 of scale plus the gap
    that Adafactor's steps on the two sides' own gradients put between
    them) and gathered slots are the port's one process's."""
    inp, refs, one, ranks, root = runs
    want = one["adafactor"]
    for r in ranks:
        got = r["adafactor"]["classifier"]
        pw = "stages.3.0.pwconv1.weight"
        assert pw in got["split"] and got["factored"][pw] and got["count"] == 2
        close(got["losses"][0], refs["adafactor_classifier"]["loss"], "JAX loss", RTOL)
        close(np.array(got["losses"]), np.array(want["losses"]), "losses", PORT_RTOL)
        for step in range(2):
            _close_sd(got["grads"][step], want["grads"][step], f"step {step} grad", GRAD_RTOL)
            _close_updated(got["whole"][step], want["whole"][step], got["grads"][:step + 1],
                           want["grads"][:step + 1], f"step {step} param", CLS_LR, clip=1.0,
                           start=inp["ada_sd"])
            for slot in worker.ADA_SLOTS:
                _close_sd(got["opt"][step][slot], want["opt"][step][slot], f"{slot}", RTOL)


def test_adafactor_pth_is_the_one_process_file_and_resumes_at_1x4(runs):
    """The ``.pth`` rank 0 saved at (2, 2) after the first Adafactor step
    holds the one-process file's keys and shapes, v_row/v_col/v included;
    (1, 4) resumed from the one-process file after that step continues its
    run."""
    inp, refs, one, ranks, root = runs
    grid = pth_io.load(root / "ada22" / "checkpoint-0.pth")
    flat = pth_io.load(root / "ada_one" / "checkpoint-0.pth")
    assert grid["model"].keys() == flat["model"].keys()
    for k, v in flat["model"].items():
        assert grid["model"][k].shape == v.shape, k
    assert grid["optimizer"].keys() == flat["optimizer"].keys()
    assert grid["optimizer"]["opt"] == "adafactor" and grid["optimizer"]["count"] == 1
    for slot in worker.ADA_SLOTS:
        assert grid["optimizer"][slot].keys() == flat["optimizer"][slot].keys()
        for k, v in flat["optimizer"][slot].items():
            assert grid["optimizer"][slot][k].shape == v.shape, (slot, k)
        _close_sd(grid["optimizer"][slot], flat["optimizer"][slot], f"saved {slot}")
    want = one["adafactor"]
    for r in ranks:
        res = r["adafactor"]["resume"]
        assert res["count"] == 2
        assert res["factored"]["stages.3.0.pwconv1.weight"]
        close(res["losses"][0], want["losses"][1], "loss", PORT_RTOL)
        _close_sd(res["grads"][0], want["grads"][1], "grad", GRAD_RTOL)
        _close_updated(res["whole"][0], want["whole"][1], want["grads"][:1] + res["grads"],
                       want["grads"], "resumed param", CLS_LR, clip=1.0, start=inp["ada_sd"])
        for slot in worker.ADA_SLOTS:
            _close_sd(res["opt"][0][slot], want["opt"][1][slot], f"resumed {slot}")


def test_adafactor_broadcast_keeps_each_rank_its_slot_shards(runs):
    """``broadcast_state`` of the Adafactor leaves at (2, 2), each rank's
    slots moved by its rank first: a slot that keeps the split dim (v_col
    of a leaf split on optax's d0, v_row of one split on d1, v of a split
    bias) comes from data index 0 of its data group, so each rank keeps its
    own shard; every other slot (reduced over the split dim, or of a
    replicated leaf) from global rank 0."""
    inp, refs, one, ranks, root = runs
    for i, r in enumerate(ranks):
        m = i % 2
        got = r["broadcast"]["adafactor"]
        for slot, per_name in got.items():
            for k, v in per_name.items():
                torch.testing.assert_close(v, torch.full_like(v, m if k in LEAF_SPLIT[slot] else 0),
                                           rtol=0, atol=0, msg=f"{slot} {k}")
        assert got["v_col"]["a.pwconv1.weight"].shape == (256,)
        assert got["v_row"]["b.proj.weight"].shape == (128,)


def test_adafactor_slots_follow_the_whole_leaf():
    """On a model axis of 4 (no collective is made), Adafactor sizes and
    places each slot from the whole leaf: the (256, 384) leaf's shard
    (96, 256) is factored, v_row whole (256) and v_col the shard's (96);
    ``state_split_dims`` names the split dims ``gather_state`` and
    ``place_state`` use."""
    grid = tmesh.Mesh(None, None, None, 0, 1, 1, 4)
    leaf = tmesh.shard_params(worker.leaf_module(), grid)
    opt = worker.adafactor_opt(leaf, grid, 1e-2)
    at = dict(zip(opt.names, range(len(opt.names))))
    i = at["c.pred_x.weight"]
    assert tuple(opt.params[i].shape) == (96, 256) and opt.factored[i] == (1, 0)
    assert opt.slots["v_row"][i].shape == (256,) and opt.slots["v_col"][i].shape == (96,)
    assert tmesh.param_sharding_rules("c.pred_x.weight", (384, 256), 4) == 0
    dims = opt.state_split_dims()
    assert {k: set(v) for k, v in dims.items()} == LEAF_SPLIT
    assert all(d == 0 for v in dims.values() for d in v.values())
    assert sum(opt.state_shards()) == sum(opt.shards) + sum(map(len, LEAF_SPLIT.values())) == 16


def test_a_grid_without_shards_is_refused():
    """A grid whose split params are not named is refused before any step."""
    grid = tmesh.Mesh(None, None, None, 0, 0, 1, 2)
    named = list(ConvNeXtV2(**CLS_KW, sparse=False).named_parameters())
    with pytest.raises(ValueError, match="shard"):
        AdamW(named, lambda c: 1e-3, process_group=grid)


def test_flagged_params_without_a_model_axis_are_refused():
    """A param flagged as a shard without a model axis has no known whole
    leaf (Adafactor's factoring and means, the norms need it): refused
    before any step, whatever the family."""
    named = list(ConvNeXtV2(**CLS_KW, sparse=False).named_parameters())
    for opt in ("adafactor", "adamw"):
        with pytest.raises(ValueError, match="model axis"):
            toptim.Optimizer(named, lambda c: 1e-3, opt=opt,
                             shards={"stages.0.0.pwconv1.weight"})

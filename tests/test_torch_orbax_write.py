"""The port's writer of the JAX package's Orbax checkpoints
(``mmearth_tpu_torch/checkpoints/{zarr,to_flax,convert,orbax_io}.py``,
``scripts/torch_to_orbax.py``) on the CPU, held against this host's orbax
and the JAX package (the port imports neither): zarr arrays as orbax writes
them; the params inverse against each JAX model's own param tree; every
``--opt`` family's step restored by JAX's ``restore_explicit``, its
``_METADATA`` equal to JAX's own save, and JAX's next update equal to the
port's; a pretraining run auto-resumed by ``CheckpointIO.restore`` to the
port's next losses; the EMA and ``batch_stats``; ``checkpoint-best`` through
``load_params`` and ``load_pretrained``; a staged seg run past its unfreeze;
the grain position through JAX's ``GrainLoader``; the script on a
``--loader grain`` run of the CLI."""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

import _torch_orbax_fixture as fx
from mmearth_tpu.checkpoints import load_pretrained as jlp
from mmearth_tpu.checkpoints import orbax_io as jorbax
from mmearth_tpu.data import grain_pipeline as jgp
from mmearth_tpu.models import convnextv2 as jcnx
from mmearth_tpu.models import fcmae as jfc
from mmearth_tpu.models import resnet as jres
from mmearth_tpu.models import unet as junet
from mmearth_tpu.train import optim as joptim
from mmearth_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
from mmearth_tpu.train.step import TrainState
from mmearth_tpu_torch import main_pretrain
from mmearth_tpu_torch.checkpoints import convert, orbax_io, pth_io, zarr
from mmearth_tpu_torch.configs import config as tconfig
from mmearth_tpu_torch.data import grain_pipeline as tgp
from mmearth_tpu_torch.data.synthetic import generate
from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
from mmearth_tpu_torch.models.fcmae import FCMAE
from mmearth_tpu_torch.models.resnet import BasicBlock, ResNet, build_resnet
from mmearth_tpu_torch.models.unet import ConvNeXtV2Unet
from mmearth_tpu_torch.train import finetune as tft
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train.ema import init_ema, update_ema
from mmearth_tpu_torch.train.schedule import warmup_cosine
from mmearth_tpu_torch.train.step import pretrain_step

from _torch_parity import np_tree
from test_torch_orbax import (CLS_DEPTHS, CLS_DIMS, FAMILIES, NCLS, SCHED, _assert_bit_equal,
                              _classifier, _Toy, _trainable)
from test_torch_unet import DEPTHS as UNET_DEPTHS
from test_torch_unet import DIMS as UNET_DIMS
from test_torch_unet import N_TRAIN, seg_case  # noqa: F401 (a fixture)
from test_torch_unet import _cfg as _seg_cfg

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import torch_to_orbax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metadata(step) -> list:
    """(key path, value type, write shape) of every leaf of a step's
    ``_METADATA``, in its order."""
    meta = json.loads((Path(step) / "default" / "_METADATA").read_text())["tree_metadata"]
    return [(k, v["value_metadata"]["value_type"], v["value_metadata"].get("write_shape"))
            for k, v in meta.items()]


def _jax_own_save(tmp_path, state) -> Path:
    io = jorbax.CheckpointIO(tmp_path / "jax_own")
    io.save(0, state)
    io.wait()
    return tmp_path / "jax_own" / "checkpoints" / "0"


def _plain_payload(state) -> dict:
    """JAX's payload of ``state`` as the port's reader gives a tree."""
    return convert._plain(jax.tree_util.tree_map(np.asarray, jorbax._state_payload(state)))


# ---------------------------------------------------------------------------
# zarr arrays
# ---------------------------------------------------------------------------
ARRAY_DTYPES = {"f32": jnp.float32, "i32": jnp.int32, "bf16": jnp.bfloat16}
ARRAY_SHAPES = {0: (), 1: (5,), 4: (3, 1, 2, 4)}


@pytest.fixture(scope="module")
def orbax_arrays(tmp_path_factory):
    """Orbax's own per-array save (``use_ocdbt=False``) of each dtype and
    rank, and the arrays."""
    root = tmp_path_factory.mktemp("arrays")
    rng = np.random.default_rng(0)
    tree = {f"{d}_{n}": jnp.asarray(rng.normal(size=shape) * 100, ARRAY_DTYPES[d])
            for d in ARRAY_DTYPES for n, shape in ARRAY_SHAPES.items()}
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(root / "orbax", tree)
    return root / "orbax", tree


@pytest.mark.parametrize("ndim", sorted(ARRAY_SHAPES))
@pytest.mark.parametrize("dtype", sorted(ARRAY_DTYPES))
def test_write_array_is_orbaxs_zarray_and_reads_back(orbax_arrays, tmp_path, dtype, ndim):
    """``.zarray`` field for field what orbax writes for the same array
    (the compressor aside: null here, zstd there), the chunk named as
    orbax names it, and the array read back bit for bit."""
    ref_root, tree = orbax_arrays
    name = f"{dtype}_{ndim}"
    a = tree[name]
    leaf = (torch.from_numpy(np.asarray(a.astype(jnp.float32))).bfloat16() if dtype == "bf16"
            else np.asarray(a))
    zarr.write_array(tmp_path, name, leaf)
    mine = json.loads((tmp_path / name / ".zarray").read_text())
    ref = json.loads((ref_root / name / ".zarray").read_text())
    assert mine.pop("compressor") is None and ref.pop("compressor")["id"] == "zstd"
    assert mine == ref and list(mine) == list(ref)
    chunks = sorted(p.name for p in (ref_root / name).iterdir() if p.name != ".zarray")
    assert sorted(p.name for p in (tmp_path / name).iterdir() if p.name != ".zarray") == chunks
    with zarr.DirectoryStore(tmp_path) as store:
        got, dtype_name = zarr.read_array(store, name)
    with zarr.DirectoryStore(ref_root) as store:
        meta = zarr.read_meta(store, name)
    assert dtype_name == meta["dtype"]
    want = np.asarray(a).view(np.uint16) if dtype == "bf16" else np.asarray(a)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the params inverse
# ---------------------------------------------------------------------------
def _jax_init(kind):
    """(JAX's param tree shapes, its batch_stats shapes or None, the port's
    model of the same kind) of each model kind the port runs."""
    key = jax.random.PRNGKey(0)
    if kind.startswith("fcmae"):
        kw = {**fx.model_kwargs(fx.CONFIG), "use_orig_stem": kind == "fcmae_orig_stem"}
        sample = jfc.zero_nan_inputs({k: jnp.asarray(v[:2]) for k, v in
                                      fx.batches_and_masks(fx.CONFIG)[0][0].items()})
        shapes = jax.eval_shape(lambda: jfc.FCMAE(**kw).init({"params": key, "mask": key},
                                                             sample))
        return shapes["params"], None, FCMAE(**kw)
    if kind == "classifier":
        jm = jcnx.ConvNeXtV2(patch_size=8, img_size=56, in_chans=12, num_classes=NCLS,
                             depths=CLS_DEPTHS, dims=CLS_DIMS, sparse=False)
        shapes = jax.eval_shape(lambda: jm.init(key, jnp.zeros((1, 56, 56, 12))))
        return shapes["params"], None, ConvNeXtV2(patch_size=8, img_size=56, in_chans=12,
                                                  depths=CLS_DEPTHS, dims=CLS_DIMS,
                                                  sparse=False, num_classes=NCLS)
    if kind == "unet":
        kw = dict(patch_size=8, img_size=32, in_chans=12, num_classes=7, depths=UNET_DEPTHS,
                  dims=UNET_DIMS)
        shapes = jax.eval_shape(lambda: junet.ConvNeXtV2Unet(**kw).init(
            key, jnp.zeros((1, 32, 32, 12))))
        return shapes["params"], None, ConvNeXtV2Unet(**kw)
    jm = {"resnet18": jres.resnet18, "resnet50": jres.resnet50,
          "resnet18_unet": jres.resnet18_unet}[kind](num_classes=5, in_chans=3)
    shapes = jax.eval_shape(lambda: jm.init(key, jnp.zeros((1, 32, 32, 3))))
    return shapes["params"], shapes["batch_stats"], build_resnet(kind, num_classes=5,
                                                                 in_chans=3)


@pytest.mark.parametrize("kind", ["fcmae", "fcmae_orig_stem", "classifier", "unet", "resnet18",
                                  "resnet50", "resnet18_unet"])
def test_params_inverse_is_jaxs_own_tree(kind):
    """JAX's own param tree of each model kind (its ``init``'s structure,
    seeded values), carried into the port (``params_converter``, strictly
    loaded) and back (``flax_converter``): bit-equal, keys and shapes too,
    and the ResNets' ``batch_stats`` with them."""
    shapes, stat_shapes, model = _jax_init(kind)
    rng = np.random.default_rng(1)

    def fill(s):
        return rng.normal(size=s.shape).astype(np.float32)

    params = jax.tree_util.tree_map(fill, shapes)
    stats = None if stat_shapes is None else jax.tree_util.tree_map(
        lambda s: rng.uniform(0.5, 1.5, size=s.shape).astype(np.float32), stat_shapes)
    sd = convert.params_converter(model, stats)(params)
    model.load_state_dict(pth_io.model_state(sd, model), strict=True)
    got, got_stats = convert.flax_converter(model)(model.state_dict())
    _assert_bit_equal(got, params)
    if stats is None:
        assert got_stats is None
    else:
        _assert_bit_equal(got_stats, stats)


# ---------------------------------------------------------------------------
# every --opt family
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("opt,probe,layer_decay,update_freq", FAMILIES)
def test_each_family_step_is_restored_by_jax(tmp_path, opt, probe, layer_decay, update_freq):
    """The port's optimizer takes ``2 * update_freq - 1`` micro-steps
    (clip on) and writes the step; its ``_METADATA`` (key paths, value
    types, shapes, in order) is that of JAX's own save of the same
    ``make_finetune_optimizer`` state; JAX's ``restore_explicit`` takes it,
    ``step`` equal, and the port's reader reads it back bit-equal to what
    JAX restored; JAX's next update equals the port's in params and slots
    (rtol 1e-5, atol 1e-6 of each tensor's scale)."""
    tm, params = _classifier()
    for name, p in tm.named_parameters():
        p.requires_grad_(_trainable(probe)(name))
    named = [(n, p) for n, p in tm.named_parameters() if p.requires_grad]
    port = toptim.Optimizer(
        named, warmup_cosine(*SCHED), 0.05, (0.9, 0.999), eps=1e-8, update_freq=update_freq,
        clip_grad=1.0, wd_mask=toptim.finetune_wd_mask(named),
        lr_scales=(toptim.layer_lr_scales(named, layer_decay, CLS_DEPTHS)
                   if layer_decay != 1.0 else None), opt=opt)
    rng = np.random.default_rng(7)
    grads = [jax.tree_util.tree_map(lambda p: (0.05 * rng.normal(size=p.shape)).astype(
        np.float32), params) for _ in range(2 * update_freq)]
    to_port = convert.params_converter(tm)

    def port_step(g):
        port_g = to_port(g)
        for name, p in named:
            p.grad = port_g[name].reshape(p.shape).clone()
        return port.step()

    for g in grads[:-1]:
        port_step(g)
    orbax_io.save(tmp_path, 0, tm, port, {"opt": opt})
    step = tmp_path / "checkpoints" / "0"

    tx = joptim.make_finetune_optimizer(
        params, jax_warmup_cosine(*SCHED), 0.05, (0.9, 0.999), layer_decay, "single",
        CLS_DEPTHS, trainable_mask=joptim.zero_grads_mask(params, _trainable(probe)),
        update_freq=update_freq, clip_grad=1.0, opt=opt)
    target = TrainState.create(params, tx)
    assert _metadata(step) == _metadata(_jax_own_save(tmp_path, target))
    state, epoch = jorbax.restore_explicit(target, step)
    assert epoch == 0 and int(state.step) == 2 * update_freq - 1
    _assert_bit_equal(orbax_io.load_tree(step), _plain_payload(state))

    upd, opt_state = jax.jit(tx.update)(grads[-1], state.opt_state, state.params)
    new_params = optax.apply_updates(state.params, upd)
    assert port_step(grads[-1])
    want = to_port(np_tree(new_params))
    for name, v in tm.state_dict().items():
        w = want[name].reshape(v.shape)
        torch.testing.assert_close(v, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()),
                                   msg=f"{opt} {name}")
    ref = convert.from_jax_opt_state(np_tree(opt_state), port, np_tree(new_params), to_port)
    assert ref["count"] == port.count and ref["mini_step"] == port.mini_step
    for key, ts_ in port.slots.items():
        for name, t in zip(port.names, ts_):
            w = ref[key][name]
            torch.testing.assert_close(t, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()) + 1e-30,
                                       msg=f"{opt} {key} {name}")


# ---------------------------------------------------------------------------
# pretraining
# ---------------------------------------------------------------------------
def test_pretrain_step_auto_resumes_in_jax_to_the_ports_losses(tmp_path):
    """The committed fixture's configuration (``update_freq`` 2, clip on):
    the port takes 3 f32 micro-steps and writes epoch 0 mid-accumulation;
    JAX's ``CheckpointIO(out).restore`` (auto-resume) takes it, ``step`` 3;
    its next two losses are the port's within 1e-6 relative.  The step is
    JAX's ``--finetune`` source too (``encoder_tree_from_checkpoint``)."""
    cfg = fx.CONFIG
    model = FCMAE(**fx.model_kwargs(cfg)).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        for name, p in model.named_parameters():
            if ".grn." in name:
                p.copy_(0.5 * torch.randn(p.shape, generator=gen))
    opt = toptim.AdamW(model.named_parameters(), warmup_cosine(*cfg["schedule"]),
                       cfg["weight_decay"], tuple(cfg["betas"]), update_freq=cfg["update_freq"],
                       clip_grad=cfg["clip_grad"])
    batches, masks = fx.batches_and_masks(cfg)
    k = cfg["micro_steps_saved"]
    gen = torch.Generator().manual_seed(0)

    def port_step(i):
        return float(pretrain_step(model, opt, {n: torch.from_numpy(v) for n, v in
                                                batches[i].items()}, i, gen, random_crop=False,
                                   mask=torch.from_numpy(masks[i]))["loss"])

    for i in range(k):
        port_step(i)
    orbax_io.save(tmp_path, 0, model, opt, {})
    saved = convert.flax_converter(model)(model.state_dict())[0]

    jm = jfc.FCMAE(**fx.model_kwargs(cfg))
    params = jax.tree_util.tree_map(jnp.asarray, convert.flax_converter(model)(
        FCMAE(**fx.model_kwargs(cfg)).state_dict())[0])
    tx = joptim.make_pretrain_optimizer(params, jax_warmup_cosine(*cfg["schedule"]),
                                        cfg["weight_decay"], tuple(cfg["betas"]),
                                        update_freq=cfg["update_freq"], clip_grad=cfg["clip_grad"])
    state, epoch = jorbax.CheckpointIO(tmp_path).restore(TrainState.create(params, tx))
    assert epoch == 0 and int(state.step) == k == convert.jax_step(opt.state_dict(), 2)

    def loss_fn(p, b, m):
        return jm.apply({"params": p}, b, mask=m)[0]

    @jax.jit
    def jax_step(st, b, m):
        loss, g = jax.value_and_grad(loss_fn)(st.params, b, m)
        return st.apply_gradients(g), loss

    for i in range(k, k + cfg["micro_steps_after"]):
        b = jfc.zero_nan_inputs({n: jnp.asarray(v) for n, v in batches[i].items()})
        state, loss = jax_step(state, b, jnp.asarray(masks[i]))
        np.testing.assert_allclose(port_step(i), float(loss), rtol=1e-6)
    enc = jlp.encoder_tree_from_checkpoint(tmp_path / "checkpoints" / "0", cfg["depths"])
    _assert_bit_equal(enc, saved["encoder"])


# ---------------------------------------------------------------------------
# EMA and batch_stats, the params directory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("probe", [False, True])
def test_finetune_ema_and_batch_stats_restore_bit_equal(tmp_path, probe):
    """A ResNet finetune (or its probe: ``fc`` alone trains, the rest's
    slots are zeros) with ``--model_ema``: params, BatchNorm statistics
    moved by train-mode steps (``num_batches_tracked`` aside, which flax
    does not keep), the EMA and the AdamW slots written as
    epoch 2 and auto-resumed by JAX's ``CheckpointIO`` bit-equal, its
    ``_METADATA`` that of JAX's own save."""
    tm = ResNet((1, 1), BasicBlock, num_classes=NCLS, in_chans=3)
    tm.init_weights(torch.Generator().manual_seed(0))
    trainable = (lambda n: n.startswith("fc")) if probe else (lambda n: True)
    for name, p in tm.named_parameters():
        p.requires_grad_(trainable(name))
    named = [(n, p) for n, p in tm.named_parameters() if p.requires_grad]
    port = toptim.Optimizer(named, warmup_cosine(*SCHED), 0.05, (0.9, 0.999), clip_grad=1.0,
                            wd_mask=toptim.finetune_wd_mask(named))
    ema = init_ema(tm)
    tm.train()
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((4, 3, 16, 16), generator=gen)
    for _ in range(2):
        tm(x.permute(0, 2, 3, 1)).square().mean().backward()
        port.step()
        update_ema(ema, tm, 0.9)
    orbax_io.save(tmp_path, 2, tm, port, {}, ema=ema)

    params, stats = convert.flax_converter(tm)(ResNet((1, 1), BasicBlock, num_classes=NCLS,
                                                      in_chans=3).state_dict())
    params, stats = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, stats))
    tx = joptim.make_finetune_optimizer(
        params, jax_warmup_cosine(*SCHED), 0.05, trainable_mask=joptim.zero_grads_mask(
            params, (lambda n: n.startswith("fc")) if probe else (lambda n: True)),
        clip_grad=1.0, opt="adamw")
    target = TrainState.create(params, tx, model_state={"batch_stats": stats},
                               ema_params=params)
    assert _metadata(tmp_path / "checkpoints" / "2") == _metadata(_jax_own_save(tmp_path, target))
    state, epoch = jorbax.CheckpointIO(tmp_path).restore(target)
    assert epoch == 2 and int(state.step) == 2
    to_port = convert.params_converter(tm, np_tree(state.model_state["batch_stats"]))
    held = tm.state_dict()
    for k, v in to_port(np_tree(state.params)).items():  # flax keeps no num_batches_tracked
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(held[k], v.reshape(held[k].shape)), k
    got_ema = to_port(np_tree(state.ema_params))
    assert all(torch.equal(t, got_ema[n].reshape(t.shape)) for n, t in ema.items())
    ref = convert.from_jax_opt_state(np_tree(state.opt_state), port, np_tree(state.params),
                                     to_port)
    assert ref["count"] == port.count == 2
    for key in ("mu", "nu"):
        assert all(torch.equal(t, ref[key][n]) for n, t in zip(port.names, port.slots[key]))
    if probe:  # the frozen params' slots are zeros
        mu = convert._plain(np_tree(state.opt_state))[2]["mu"]
        assert all(not np.any(leaf) for path, leaf in convert.tree_leaves(mu)
                   if path[0] != "fc")
    _assert_bit_equal(orbax_io.load_tree(tmp_path / "checkpoints" / "2"), _plain_payload(state))


def test_checkpoint_best_is_read_by_load_params_and_load_pretrained(tmp_path):
    """The classifier's ``checkpoint-best`` (``save_params``): JAX's
    ``load_params`` with no target and the port's reader give its param
    tree bit for bit; ``load_pretrained`` takes it (``encoder_tree_from_
    checkpoint``, ``load_encoder_into`` a fresh JAX classifier); a second
    save replaces it."""
    tm, params = _classifier()
    with torch.no_grad():
        tm.head.weight.add_(1.0)
    tree = convert.flax_converter(tm)(tm.state_dict())[0]
    path = orbax_io.save_params(tmp_path / "checkpoint-best", tree)
    got = jax.tree_util.tree_map(np.asarray, jorbax.load_params(path))
    _assert_bit_equal(got, tree)
    _assert_bit_equal(orbax_io.load_params(path), tree)
    enc = jlp.encoder_tree_from_checkpoint(path, CLS_DEPTHS)
    merged = jlp.load_encoder_into(jax.tree_util.tree_map(np.asarray, params), enc)
    _assert_bit_equal(merged, tree)
    orbax_io.save_params(path, params)
    _assert_bit_equal(jax.tree_util.tree_map(np.asarray, jorbax.load_params(path)),
                      np_tree(params))
    assert [p.name for p in tmp_path.iterdir()] == ["checkpoint-best"]


# ---------------------------------------------------------------------------
# the staged seg run
# ---------------------------------------------------------------------------
def test_staged_seg_run_restores_into_jaxs_probe_target(seg_case, monkeypatch, tmp_path):
    """A U-Net probe with ``--model_ema`` saved at epoch 1, past its
    unfreeze at 1: the unfrozen optimizer's step restores into JAX's target
    of the probe's optimizer (``train/finetune.py:248``, the same optax tree
    whatever its mask), params and EMA bit-equal.  JAX then builds a fresh
    optimizer at the unfreeze, as its own run does, so slots are not
    compared."""
    monkeypatch.setattr(tft, "model_size", lambda name: (UNET_DEPTHS, UNET_DIMS))
    base = _seg_cfg(seg_case)
    out = tmp_path / "out"
    cfg = dataclasses.replace(base, model_ema=True, model_ema_decay=0.5, run=tconfig.RunConfig(
        epochs=2, seed=0, use_bf16=False, loss_aggr="unweighted", output_dir=str(out)))
    held = tft.run_finetune(cfg, device="cpu")
    ckpt = pth_io.load(out / "checkpoint-1.pth")
    model, opt = held["model"], held["optimizer"]
    assert len(opt.names) > sum(1 for n, _ in model.named_parameters()
                                if tft.probe_trainable(model)(n))
    orbax_io.save(tmp_path / "jax", 1, model, opt, {}, ema=ckpt["ema"])

    params, _ = convert.flax_converter(model)(model.state_dict())
    params = jax.tree_util.tree_map(jnp.zeros_like, params)
    tx = joptim.make_finetune_optimizer(
        params, jax_warmup_cosine(*SCHED), 0.3, (0.9, 0.999), 0.9, "single", UNET_DEPTHS,
        trainable_mask=joptim.zero_grads_mask(params, jlp.unet_probe_trainable))
    target = TrainState.create(params, tx, ema_params=params)
    state, epoch = jorbax.restore_explicit(target, tmp_path / "jax")
    assert epoch == 1
    to_port = convert.params_converter(model)
    want = to_port(np_tree(state.params))
    assert all(torch.equal(v, want[k].reshape(v.shape)) for k, v in model.state_dict().items())
    got_ema = to_port(np_tree(state.ema_params))
    assert all(torch.equal(t, got_ema[n].reshape(t.shape)) for n, t in ckpt["ema"].items())
    assert int(state.step) == opt.count == N_TRAIN // base.batch_size


# ---------------------------------------------------------------------------
# the grain position
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def toy_pack(tmp_path_factory):
    pack = tmp_path_factory.mktemp("toy") / "pack"
    jgp.pack_arrayrecord(_Toy(21), pack, shard_size=16)
    return pack


@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_grain_state_is_jaxs_and_continues_its_stream(toy_pack, shard, epoch):
    """The port's stream position at the end of epoch 0 or 1 becomes the
    bytes JAX's ``GrainLoader.get_state()`` gives at the same epoch end
    (worker count 0); JAX's ``set_state`` on them gives JAX's next batch; a
    position inside an epoch is refused."""
    meta = json.loads((toy_pack / "meta.json").read_text())
    jl = jgp.GrainLoader(toy_pack, batch_size=4, seed=3, shard=shard)
    it = jl.iterator()
    for _ in range((epoch + 1) * len(jl)):
        next(it)
    want, after = jl.get_state(), next(it)["x"]
    port = tgp.GrainLoader(toy_pack, batch_size=4, seed=3, shard=shard)
    pit = port.iterator()
    for _ in range((epoch + 1) * len(port)):
        next(pit)
    mine = orbax_io.grain_state(port.get_state(), meta["count"], meta["shards"], toy_pack, 4, 0)
    assert mine == want
    fresh = jgp.GrainLoader(toy_pack, batch_size=4, seed=3, shard=shard)
    fresh.set_state(mine)
    assert np.array_equal(next(fresh.iterator())["x"], after)
    next(pit)
    with pytest.raises(ValueError, match="only an epoch boundary"):
        orbax_io.grain_state(port.get_state(), meta["count"], meta["shards"], toy_pack, 4, 0)


# (worker count, shard, epoch) -> (last_seen_indices, last_worker_index) that
# JAX's GrainLoader (grain's DataLoader with worker processes) reported at the
# end of each epoch of the 21-record toy pack at batch 4, seed 3, on this
# host's grain; a multi-worker loader takes 8-18 s to start, too long to
# run here each time
GRAIN_WORKERS = {
    (2, (0, 1), 0): ({"0": 18, "1": 19}, 1), (2, (0, 1), 1): ({"0": 40, "1": 39}, 0),
    (2, (0, 1), 2): ({"0": 60, "1": 61}, 1), (2, (1, 2), 0): ({"0": 13, "1": 15}, 1),
    (2, (1, 2), 1): ({"0": 33, "1": 35}, 1), (2, (1, 2), 2): ({"0": 53, "1": 55}, 1),
    (3, (0, 1), 0): ({"0": 18, "1": 19, "2": 17}, 1),
    (3, (0, 1), 1): ({"0": 39, "1": 40, "2": 38}, 1),
    (3, (0, 1), 2): ({"0": 60, "1": 61, "2": 59}, 1),
    (3, (1, 2), 0): ({"0": 13, "1": 15, "2": 11}, 1),
    (3, (1, 2), 1): ({"0": 31, "1": 33, "2": 35}, 2),
    (3, (1, 2), 2): ({"0": 55, "1": 51, "2": 53}, 0)}


def test_grain_state_with_worker_processes(toy_pack):
    """With 2 and 3 workers the position names each worker's last record
    as grain recorded it; the reprs are those of JAX's loader."""
    meta = json.loads((toy_pack / "meta.json").read_text())
    for (workers, shard, epoch), (last, last_worker) in GRAIN_WORKERS.items():
        per = len(tgp.GrainLoader(toy_pack, batch_size=4, seed=3, shard=shard)) * 4
        pos = json.dumps({"epoch": epoch, "pos": per, "seed": 3, "shard": list(shard)}).encode()
        obj = json.loads(orbax_io.grain_state(pos, meta["count"], meta["shards"], toy_pack, 4,
                                              workers))
        grain = json.loads(obj["grain"])
        assert (grain["last_seen_indices"], grain["last_worker_index"]) == (last, last_worker)
        assert grain["worker_count"] == workers and obj["mmearth_pos"] == per
    jl = jgp.GrainLoader(toy_pack, batch_size=4, seed=3, shard=(1, 2), worker_count=2)
    ref = json.loads(json.loads(jl.get_state())["grain"])
    pos = json.dumps({"epoch": 0, "pos": 0, "seed": 3, "shard": [1, 2]}).encode()
    mine = json.loads(json.loads(orbax_io.grain_state(pos, meta["count"], meta["shards"],
                                                      toy_pack, 4, 2))["grain"])
    assert mine == ref


# ---------------------------------------------------------------------------
# the script on a CLI run
# ---------------------------------------------------------------------------
def test_script_turns_a_grain_run_into_what_jax_auto_resumes(tmp_path, monkeypatch):
    """``main_pretrain --loader grain`` (the fixture's narrow size, one
    epoch) writes ``checkpoint-0.pth``; ``scripts/torch_to_orbax.py`` turns
    its directory into the step and its grain position; JAX's
    ``CheckpointIO`` restores the step into the target its driver builds
    for the same flags (params as the ``.pth`` holds them), and its
    ``GrainLoader`` takes the position and gives the next epoch's first
    batch."""
    cfg = fx.CONFIG
    monkeypatch.setitem(tconfig.MODEL_SIZES, cfg["model_size"],
                        (tuple(cfg["depths"]), tuple(cfg["dims"])))
    generate(tmp_path / "h5", n=14, tile=64, seed=1)
    out = tmp_path / "run"
    argv = ["--model", "convnextv2_fixture", "--input_size", "56", "--patch_size", "8",
            "--decoder_embed_dim", str(cfg["decoder_embed_dim"]), "--batch_size", "4",
            "--update_freq", "2", "--device", "cpu", "--data_dir", str(tmp_path / "h5"),
            "--processed_dir", str(tmp_path / "data"), "--epochs", "1", "--warmup_epochs", "1",
            "--use_bf16", "False", "--loader", "grain", "--output_dir", str(out),
            "--block_impl", "wholeblock"]
    model, _, opt = main_pretrain.main(main_pretrain.get_args_parser().parse_args(argv))
    records = torch_to_orbax.convert(out, num_workers=0)
    assert [r["wrote"] for r in records] == [str(out.absolute() / "checkpoints" / "0")]

    params = jax.tree_util.tree_map(jnp.asarray, convert.flax_converter(model)(
        model.state_dict())[0])
    tx = joptim.make_pretrain_optimizer(params, lambda c: 0.0, 0.05, (0.9, 0.95), update_freq=2)
    state, epoch = jorbax.CheckpointIO(out).restore(TrainState.create(
        jax.tree_util.tree_map(jnp.zeros_like, params), tx))
    assert epoch == 0 and int(state.step) == 3 == convert.jax_step(opt.state_dict(), 2)
    _assert_bit_equal(np_tree(state.params), np_tree(params))
    pack = tmp_path / "data" / "train_arrayrecord"
    jl = jgp.GrainLoader(pack, batch_size=4, seed=0, shard=(0, 1))
    jl.set_state(jorbax.CheckpointIO(out).loader_state(0))
    ref = jgp.GrainLoader(pack, batch_size=4, seed=0, shard=(0, 1))
    it = ref.iterator()
    for _ in range(len(ref)):
        next(it)
    assert jl.get_state() == ref.get_state()
    got, want = next(jl.iterator()), next(it)
    assert all(np.array_equal(got[k], want[k], equal_nan=True) for k in want)

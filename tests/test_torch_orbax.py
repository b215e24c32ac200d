"""The port's reader of the JAX package's Orbax checkpoints
(``mmearth_tpu_torch/checkpoints/{zstd,ocdbt,zarr,orbax_io}.py`` and
``convert.from_jax_opt_state``) on the CPU, with this host's orbax and
tensorstore as the oracle (the port imports neither): OCDBT stores of many
commits and tiny nodes read key for key, damaged ones refused; zarr arrays
with fill values and compressors; Orbax trees saved from the 8-device mesh
bit-equal to ``StandardCheckpointer().restore``; a full-width atto FCMAE and
its AdamW slots loaded strictly, bit for bit; a pretraining run saved
mid-accumulation and auto-resumed by the port, whose next update equals
JAX's; every ``--opt`` family's optax state resumed for one more update;
``--finetune``, the finetune's resume (EMA and BatchNorm statistics), the
hub and the panels from Orbax; the grain position; the committed fixture."""
import json
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_orbax_fixture as fx
from mmearth_tpu.checkpoints import load_pretrained as jlp
from mmearth_tpu.checkpoints import orbax_io as jorbax
from mmearth_tpu.checkpoints.foreign import torch_resnet_to_flax
from mmearth_tpu.checkpoints.torch_convert import torch_encoder_to_flax, torch_fcmae_to_flax
from mmearth_tpu.configs import modalities as JM
from mmearth_tpu.data import grain_pipeline as jgp
from mmearth_tpu.models import fcmae as jfc
from mmearth_tpu.train import optim as joptim
from mmearth_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
from mmearth_tpu.train.step import TrainState
from mmearth_tpu_torch import hub, main_pretrain
from mmearth_tpu_torch.checkpoints import convert, ocdbt, orbax_io, pth_io, zarr
from mmearth_tpu_torch.checkpoints import load_pretrained as lp
from mmearth_tpu_torch.configs import config as tconfig
from mmearth_tpu_torch.data import geobench as gb
from mmearth_tpu_torch.data import grain_pipeline as tgp
from mmearth_tpu_torch.data.synthetic import generate_packed
from mmearth_tpu_torch.eval import visualize
from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
from mmearth_tpu_torch.models.fcmae import FCMAE
from mmearth_tpu_torch.models.resnet import BasicBlock, ResNet
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train import finetune as tft
from mmearth_tpu_torch.train import pretrain
from mmearth_tpu_torch.train.ema import init_ema
from mmearth_tpu_torch.train.schedule import warmup_cosine
from mmearth_tpu_torch.train.step import pretrain_step

from _torch_parity import np_tree, randomize_grn
from test_torch_unet import DEPTHS as UNET_DEPTHS
from test_torch_unet import DIMS as UNET_DIMS
from test_torch_unet import N_TRAIN, seg_case  # noqa: F401 (a fixture)
from test_torch_unet import _cfg as _seg_cfg

ATTO = ((2, 2, 6, 2), (40, 80, 160, 320))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return dict(convert.tree_leaves(tree))


def _bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_bit_equal(got, ref):
    g, r = _flat(got), _flat(ref)
    assert set(g) == set(r), set(g) ^ set(r)
    for k, v in r.items():
        if v is None:
            assert g[k] is None, k
            continue
        a, b = _bits(g[k]), _bits(v)
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), k


# ---------------------------------------------------------------------------
# OCDBT and zarr against tensorstore
# ---------------------------------------------------------------------------
def _ts_store(root, arity, commits, node_bytes=200, inline=20):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/", "config": {
        "max_decoded_node_bytes": node_bytes, "max_inline_value_bytes": inline,
        "version_tree_arity_log2": arity, "compression": {"id": "zstd", "level": 3}}}).result()
    rng = np.random.default_rng(commits)
    for c in range(commits):
        txn = ts.Transaction()
        for i in range(12):
            value = rng.bytes(int(rng.integers(1, 60)))
            kv.with_transaction(txn).write(f"k/{c % 5:02d}/{i:03d}{'x' * (i % 3)}", value).result()
        txn.commit_async().result()
    return kv


@pytest.mark.parametrize("arity,commits", [(4, 3), (1, 5), (1, 16), (2, 21)])
def test_ocdbt_reads_every_key_tensorstore_wrote(tmp_path, arity, commits):
    """Tiny nodes (interior B+tree nodes several levels deep), values inline
    and in data files, and enough commits that the newest root lies behind
    version tree nodes (arity 2 or 4 a level): every key and value of the
    newest version equals tensorstore's."""
    kv = _ts_store(tmp_path, arity, commits)
    ref = sorted(kv.list().result())
    with ocdbt.Store(tmp_path) as store:
        assert store.list() == ref and len(ref) > 20
        assert store.root_ref["height"] >= 2
        for key in ref:
            assert store.read(key) == kv.read(key).result().value, key
        assert store.read(b"k/none") is None


def _reframe(data: bytes, pos: int, value: int) -> bytes:
    """``data`` with byte ``pos`` set to ``value`` and its checksum redone."""
    b = bytearray(data)
    b[pos] = value
    b[-4:] = struct.pack("<I", ocdbt.crc32c(bytes(b[:-4])))
    return bytes(b)


@pytest.mark.parametrize("damage", ["node_byte", "manifest_magic", "format_version"])
def test_ocdbt_refuses_a_damaged_store(tmp_path, damage):
    _ts_store(tmp_path, 1, 3)
    if damage == "node_byte":
        with ocdbt.Store(tmp_path) as store:
            loc = store.root_ref["location"]
        path = tmp_path / loc.file
        data = bytearray(path.read_bytes())
        data[loc.offset + loc.length // 2] ^= 0x40
        path.write_bytes(bytes(data))
        with pytest.raises(ocdbt.FormatError, match="checksum"), ocdbt.Store(tmp_path) as store:
            store.list()
        return
    path = tmp_path / "manifest.ocdbt"
    data = path.read_bytes()
    if damage == "manifest_magic":
        path.write_bytes(_reframe(data, 0, 0x0D))
        match = "magic"
    else:
        path.write_bytes(_reframe(data, 12, 1))
        match = "format version 1"
    with pytest.raises(ocdbt.FormatError, match=match):
        ocdbt.Store(tmp_path)


@pytest.mark.parametrize("compressor", [{"id": "zstd", "level": 2}, None])
def test_zarr_arrays_with_edge_and_missing_chunks(tmp_path, compressor):
    """Edge chunks cut to the shape, chunks never written read as the fill
    value (f32 and bf16), a 0-d array, with and without zstd."""
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    rng = np.random.default_rng(0)
    cases = {"f": ("<f4", (7, 5), (3, 2), 2.5), "b": ("bfloat16", (6, 4), (4, 4), -1.0),
             "i": ("<i4", (), (), 0)}
    written = {}
    for name, (dtype, shape, chunks, fill) in cases.items():
        arr = ts.open({"driver": "zarr", "kvstore": {**base, "path": f"{name}/"},
                       "metadata": {"dtype": dtype, "shape": list(shape), "chunks": list(chunks),
                                    "compressor": compressor, "fill_value": fill}},
                      create=True).result()
        full = rng.normal(size=shape).astype(np.float32) * 4
        if dtype == "<i4":
            full = np.asarray(7, np.int32)
            arr.write(full).result()
        elif dtype == "bfloat16":
            arr[:4, :].write(jnp.asarray(full[:4], jnp.bfloat16)).result()  # chunk row 1 unwritten
        else:
            arr[:5, :].write(full[:5]).result()
        written[name] = arr.read().result()
    with ocdbt.Store(tmp_path) as store:
        got = {name: zarr.read_array(store, name) for name in cases}
    for name, (dtype, *_rest) in cases.items():
        got_array, dtype_name = got[name]
        assert dtype_name == dtype
        ref = np.asarray(written[name])
        if dtype == "bfloat16":
            assert torch.equal(zarr.to_torch(got_array, dtype_name),
                               torch.from_numpy(ref.astype(np.float32)).bfloat16())
        else:
            assert got_array.dtype == ref.dtype and np.array_equal(got_array, ref), name


def test_zarr_refuses_another_compressor(tmp_path):
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/", "path": "a/"}
    ts.open({"driver": "zarr", "kvstore": base, "metadata": {
        "dtype": "<f4", "shape": [4], "chunks": [4], "compressor": {"id": "zlib", "level": 1}}},
        create=True).result().write(np.ones(4, np.float32)).result()
    with pytest.raises(ValueError, match="'zlib' is not read here"), ocdbt.Store(tmp_path) as s:
        zarr.read_array(s, "a")


# ---------------------------------------------------------------------------
# Orbax trees
# ---------------------------------------------------------------------------
def test_load_tree_is_bit_equal_to_orbax_restore(tmp_path):
    """f32, bf16, int32 and 0-d leaves, small (inline) and large (in data
    files), sharded over both axes of the 8-device mesh (a chunk a shard),
    replicated, in dicts, lists and empty nodes."""
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    rng = np.random.default_rng(0)

    def put(a, spec):
        return jax.device_put(a, NamedSharding(mesh, spec))

    tree = {"f": put(rng.normal(size=(64, 48)).astype(np.float32), P("data", "model")),
            "b": put(jnp.asarray(rng.normal(size=(8, 6)), jnp.bfloat16), P("data", "model")),
            "col": put(rng.normal(size=(3, 64)).astype(np.float32), P(None, "data")),
            "i": jnp.arange(10, dtype=jnp.int32), "s": jnp.float32(3.5), "n": None,
            "t": (jnp.ones(3), {"x": jnp.zeros((2, 2), jnp.int32)}),
            "odd": put(rng.normal(size=(7, 5)).astype(np.float32), P(None, None))}
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(tmp_path / "tree", tree)
    ckptr.wait_until_finished()
    ref = jax.tree_util.tree_map(np.asarray, ocp.StandardCheckpointer().restore(tmp_path / "tree"))
    got = orbax_io.load_tree(tmp_path / "tree")
    assert isinstance(got["t"], list) and got["n"] is None
    _assert_bit_equal(got, ref)


def _atto_jax_params(seed=0):
    model = FCMAE(img_size=56, patch_size=8, depths=ATTO[0], dims=ATTO[1],
                  decoder_embed_dim=64, inp_modalities=JM.INP_MODALITIES,
                  out_modalities=JM.OUT_MODALITIES)
    model.init_weights(torch.Generator().manual_seed(seed))
    params = torch_fcmae_to_flax({k: v.numpy().copy() for k, v in model.state_dict().items()},
                                 ATTO[0], JM.OUT_MODALITIES)
    return model, randomize_grn(jax.tree_util.tree_map(jnp.asarray, params), seed=seed)


@pytest.fixture(scope="module")
def atto_run(tmp_path_factory):
    """A full-width atto56 FCMAE (decoder 64) and JAX's AdamW state with
    seeded non-zero slots, saved by ``CheckpointIO`` as epoch 0 of a run's
    output directory."""
    out = tmp_path_factory.mktemp("atto_run")
    model, params = _atto_jax_params()
    tx = joptim.make_pretrain_optimizer(params, jax_warmup_cosine(1.5e-4, 0.0, 4, 1, 2), 0.05)
    state = TrainState.create(params, tx)
    rng = np.random.default_rng(3)
    adam = state.opt_state[0]
    adam = adam._replace(
        count=jnp.int32(2),
        mu=jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.normal(size=p.shape).astype(np.float32) * 1e-3), params),
        nu=jax.tree_util.tree_map(lambda p: jnp.asarray(
            rng.uniform(size=p.shape).astype(np.float32) * 1e-6), params))
    sched = state.opt_state[2]._replace(count=jnp.int32(2))
    state = state.replace(opt_state=(adam, state.opt_state[1], sched), step=jnp.int32(2))
    io = jorbax.CheckpointIO(out)
    io.save(0, state)
    io.wait()
    return out, model, state


def test_full_width_atto_and_adamw_slots_load_bit_equal(atto_run):
    out, model, state = atto_run
    opt = toptim.AdamW(model.named_parameters(), warmup_cosine(1.5e-4, 0.0, 4, 1, 2), 0.05)
    epoch = orbax_io.restore(out / "checkpoints" / "0", model, opt)
    assert epoch == 0 and opt.count == 2 and opt.mini_step == 0
    ref = convert.from_jax_fcmae(np_tree(state.params), ATTO[0], JM.OUT_MODALITIES)
    for name, v in model.state_dict().items():
        assert torch.equal(v, ref[name].reshape(v.shape)), name
    for key, tree in (("mu", state.opt_state[0].mu), ("nu", state.opt_state[0].nu)):
        want = convert.from_jax_fcmae(np_tree(tree), ATTO[0], JM.OUT_MODALITIES)
        for name, t in zip(opt.names, opt.slots[key]):
            assert torch.equal(t, want[name].reshape(t.shape)), (key, name)
    assert orbax_io.ReadStats.bytes_read > 3 * 4 * sum(p.numel() for p in model.parameters()) / 2


# ---------------------------------------------------------------------------
# pretraining resume
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """The committed fixture's run (``_torch_orbax_fixture.build_state``),
    saved mid-accumulation by JAX's ``CheckpointIO`` into a run's output
    directory."""
    out = tmp_path_factory.mktemp("tiny_run")
    jm, state, step, batches, masks = fx.build_state()
    io = jorbax.CheckpointIO(out)
    io.save(0, state)
    io.wait()
    return out, jm, state, step, batches, masks


def _tiny_port(cfg=fx.CONFIG):
    model = FCMAE(**fx.model_kwargs(cfg))
    opt = toptim.AdamW(model.named_parameters(), warmup_cosine(*cfg["schedule"]),
                       cfg["weight_decay"], tuple(cfg["betas"]),
                       update_freq=cfg["update_freq"], clip_grad=cfg["clip_grad"])
    return model, opt


def _jax_opt_as_port(state, opt, to_port):
    return convert.from_jax_opt_state(np_tree(state.opt_state), opt, np_tree(state.params),
                                      to_port)


def test_pretrain_auto_resume_takes_jaxs_next_update(tiny_run):
    """The port resumes the run from its output directory as the driver
    does (``pretrain.resume`` with ``--auto_resume``): the state equals
    JAX's bit for bit (params, mu, nu, the accumulated gradient, the counts);
    then the micro-step that completes the accumulation and the next one
    give JAX's losses, params and slots (f32: 2e-5 of each tensor's scale)."""
    out, jm, state, step, batches, masks = tiny_run
    model, opt = _tiny_port()
    run = tconfig.RunConfig(output_dir=str(out), auto_resume=True)
    assert pretrain.resume(run, model, opt, out) == 1
    to_port = convert.params_converter(model)
    assert opt.count == 1 and opt.mini_step == 1
    ref = _jax_opt_as_port(state, opt, to_port)
    for key in ("mu", "nu", "acc"):
        for name, t in zip(opt.names, opt.slots.get(key) or opt.acc):
            assert torch.equal(t, ref[key][name]), (key, name)
    k = fx.CONFIG["micro_steps_saved"]
    gen = torch.Generator().manual_seed(0)
    st = state
    for i in (k, k + 1):
        jb = jfc.zero_nan_inputs({n: jnp.asarray(v) for n, v in batches[i].items()})
        st, loss = step(st, jb, jnp.asarray(masks[i]))
        metrics = pretrain_step(model, opt, {n: torch.from_numpy(v) for n, v in batches[i].items()},
                                i, gen, random_crop=False, mask=torch.from_numpy(masks[i]))
        np.testing.assert_allclose(float(metrics["loss"]), float(loss), rtol=1e-5)
        want = to_port(np_tree(st.params))
        for name, v in model.state_dict().items():
            w = want[name].reshape(v.shape)
            torch.testing.assert_close(v, w, rtol=0, atol=2e-5 * float(w.abs().max()) + 1e-12,
                                       msg=name)
        ref = _jax_opt_as_port(st, opt, to_port)
        for key in ("mu", "nu"):
            for name, t in zip(opt.names, opt.slots[key]):
                w = ref[key][name]
                torch.testing.assert_close(t, w, rtol=0, atol=2e-5 * float(w.abs().max()) + 1e-20,
                                           msg=f"{key} {name}")
    assert opt.count == 2 and opt.mini_step == 1 and fx.CONFIG["micro_steps_after"] == 2


@pytest.mark.parametrize("form", ["output_dir", "checkpoints", "step"])
def test_resume_takes_the_three_orbax_forms(tiny_run, form):
    out = tiny_run[0]
    path = {"output_dir": out, "checkpoints": out / "checkpoints",
            "step": out / "checkpoints" / "0"}[form]
    assert pth_io.resolve(path) == out / "checkpoints" / "0"
    model, opt = _tiny_port()
    assert pretrain.resume(tconfig.RunConfig(resume=str(path)), model, opt, None) == 1
    assert opt.count == 1 and opt.mini_step == 1


def test_auto_resume_takes_the_newest_of_either_format(tmp_path, tiny_run):
    """An Orbax epoch later than every ``.pth`` wins; a ``.pth`` wins a tie;
    an unfinished Orbax directory is not a checkpoint."""
    shutil.copytree(tiny_run[0] / "checkpoints", tmp_path / "checkpoints")
    (tmp_path / "checkpoints" / "3.orbax-checkpoint-tmp-9").mkdir()
    (tmp_path / "checkpoints" / "4").mkdir()  # no _CHECKPOINT_METADATA: unfinished
    assert pth_io.latest_checkpoint(tmp_path) == tmp_path / "checkpoints" / "0"
    (tmp_path / "checkpoint-0.pth").write_bytes(b"")
    assert pth_io.latest_checkpoint(tmp_path) == tmp_path / "checkpoint-0.pth"
    shutil.copytree(tmp_path / "checkpoints" / "0", tmp_path / "checkpoints" / "1")
    assert pth_io.latest_checkpoint(tmp_path) == tmp_path / "checkpoints" / "1"


@pytest.fixture
def fixture_size(monkeypatch):
    """The committed fixture's narrow size as ``--model convnextv2_fixture``."""
    cfg = fx.CONFIG
    monkeypatch.setitem(tconfig.MODEL_SIZES, cfg["model_size"],
                        (tuple(cfg["depths"]), tuple(cfg["dims"])))


def test_main_pretrain_auto_resumes_a_jax_output_directory(tiny_run, tmp_path, fixture_size):
    """``main_pretrain`` in the JAX run's output directory continues at
    epoch 1 from its Orbax step and writes ``checkpoint-1.pth`` beside it;
    a rerun resumes from that ``.pth``."""
    out = tmp_path / "run"
    shutil.copytree(tiny_run[0], out)
    data = generate_packed(tmp_path / "data", n=9, tile=64, seed=0)
    cfg = fx.CONFIG
    argv = ["--model", "convnextv2_fixture", "--input_size", "56", "--patch_size", "8",
            "--decoder_embed_dim", str(cfg["decoder_embed_dim"]), "--batch_size", "4",
            "--update_freq", "2", "--use_bf16", "False",
            "--device", "cpu", "--processed_dir", str(data), "--warmup_epochs", "1",
            "--epochs", "2", "--output_dir", str(out), "--block_impl", "wholeblock"]
    model, hist, opt = main_pretrain.main(main_pretrain.get_args_parser().parse_args(argv))
    assert [h["epoch"] for h in hist] == [1] and opt.count == 2 and opt.mini_step == 1
    assert [e for e, _ in pth_io.numbered_checkpoints(out)] == [1]
    assert pth_io.latest_checkpoint(out) == out / "checkpoint-1.pth"
    _, hist2, _ = main_pretrain.main(main_pretrain.get_args_parser().parse_args(
        [*argv[:-4], "--epochs", "3", "--output_dir", str(out)]))
    assert [h["epoch"] for h in hist2] == [2]


# ---------------------------------------------------------------------------
# every --opt family
# ---------------------------------------------------------------------------
CLS_DEPTHS, CLS_DIMS, NCLS = (1, 1, 1, 1), (8, 16, 24, 128), 10
SCHED = (1e-3, 1e-6, 4, 1, 3)
# (family, probe, layer decay, update_freq): each family once, with the
# probe's mask_updates, layer decay's scale_by_pytree and MultiSteps spread
# over them
FAMILIES = [("adamw", True, 1.0, 2), ("adam", False, 0.75, 1), ("nadam", False, 1.0, 2),
            ("radam", True, 0.75, 1), ("sgd", False, 0.75, 2), ("momentum", True, 1.0, 1),
            ("adadelta", False, 1.0, 1), ("adafactor", False, 0.75, 2),
            ("rmsprop", True, 0.75, 2), ("novograd", False, 0.75, 1), ("lamb", True, 1.0, 2)]


def _classifier():
    tm = ConvNeXtV2(patch_size=8, img_size=56, in_chans=12, depths=CLS_DEPTHS, dims=CLS_DIMS,
                    sparse=False, num_classes=NCLS)
    tm.init_weights(torch.Generator().manual_seed(0))
    sd = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    params = randomize_grn(jax.tree_util.tree_map(
        jnp.asarray, torch_encoder_to_flax(sd, CLS_DEPTHS, False, include_head=True)), 0)
    tm.load_state_dict(convert.from_jax_classifier(np_tree(params), CLS_DEPTHS), strict=True)
    return tm, params


def _trainable(probe):
    return (lambda n: n.startswith("head")) if probe else (lambda n: True)


@pytest.mark.parametrize("opt,probe,layer_decay,update_freq", FAMILIES)
def test_each_family_resumes_from_optax(tmp_path, opt, probe, layer_decay, update_freq):
    """optax's state after a few micro-steps of ``make_finetune_optimizer``
    (clip on), saved by Orbax and resumed by the port's optimizer of the
    same family, takes one more micro-step (one that applies an update)
    to optax's params and slots."""
    tm, params = _classifier()
    tx = joptim.make_finetune_optimizer(
        params, jax_warmup_cosine(*SCHED), 0.05, (0.9, 0.999), layer_decay, "single",
        CLS_DEPTHS, trainable_mask=joptim.zero_grads_mask(params, _trainable(probe)),
        update_freq=update_freq, clip_grad=1.0, opt=opt)
    rng = np.random.default_rng(7)
    steps = 2 * update_freq
    grads = [jax.tree_util.tree_map(lambda p: jnp.asarray(
        (0.05 * rng.normal(size=p.shape)).astype(np.float32)), params) for _ in range(steps)]
    state, update = tx.init(params), jax.jit(tx.update)
    for g in grads[:-1]:
        upd, state = update(g, state, params)
        params = optax.apply_updates(params, upd)
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(tmp_path / "state", {"params": params, "opt_state": state})
    ckptr.wait_until_finished()

    tree = orbax_io.numpy_tree(orbax_io.load_tree(tmp_path / "state"))
    tm.load_state_dict(convert.from_jax_classifier(tree["params"], CLS_DEPTHS), strict=True)
    for name, p in tm.named_parameters():
        p.requires_grad_(_trainable(probe)(name))
    named = [(n, p) for n, p in tm.named_parameters() if p.requires_grad]
    port = toptim.Optimizer(
        named, warmup_cosine(*SCHED), 0.05, (0.9, 0.999), eps=1e-8, update_freq=update_freq,
        clip_grad=1.0, wd_mask=toptim.finetune_wd_mask(named),
        lr_scales=(toptim.layer_lr_scales(named, layer_decay, CLS_DEPTHS)
                   if layer_decay != 1.0 else None), opt=opt)
    to_port = convert.params_converter(tm)
    port.load_state_dict(convert.from_jax_opt_state(tree["opt_state"], port, tree["params"],
                                                    to_port))
    if opt == "adafactor":
        assert any(f is not None for f in port.factored)
    assert port.mini_step == (steps - 1) % update_freq
    upd, state = update(grads[-1], state, params)
    params = optax.apply_updates(params, upd)
    g = convert.from_jax_classifier(np_tree(grads[-1]), CLS_DEPTHS)
    for name, p in named:
        p.grad = g[name].reshape(p.shape).clone()
    assert port.step()
    want = convert.from_jax_classifier(np_tree(params), CLS_DEPTHS)
    for name, v in tm.state_dict().items():
        w = want[name].reshape(v.shape)
        torch.testing.assert_close(v, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()),
                                   msg=f"{opt} {name}")
    ref = convert.from_jax_opt_state(np_tree(state), port, np_tree(params), to_port)
    assert ref["count"] == port.count
    for key, ts_ in port.slots.items():
        for name, t in zip(port.names, ts_):
            w = ref[key][name]
            torch.testing.assert_close(t, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()) + 1e-30,
                                       msg=f"{opt} {key} {name}")


# ---------------------------------------------------------------------------
# finetuning, the hub and the panels
# ---------------------------------------------------------------------------
def test_finetune_hub_and_panels_read_orbax(atto_run, tmp_path):
    """``--finetune <orbax>`` (a step, its payload, and a raw params
    directory) gives the encoder JAX's ``encoder_tree_from_checkpoint``
    gives; ``hub.MPMAE(ckpt_path=<orbax>)`` holds it; the panels load the
    whole FCMAE."""
    out, model, state = atto_run
    step = out / "checkpoints" / "0"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(tmp_path / "raw", state.params)
    ckptr.wait_until_finished()
    for path in (step, step / "default", tmp_path / "raw"):
        ref = jlp.encoder_tree_from_checkpoint(path, ATTO[0])
        want = convert.to_tensors(convert.from_jax_encoder(ref, ATTO[0]))
        got = lp.encoder_state_from_checkpoint(path, ATTO[0])
        for k, v in want.items():
            assert torch.equal(got[k], v.reshape(got[k].shape)), (path, k)
    cls, _ = hub.MPMAE(model_name="convnextv2_atto", ckpt_path=str(step), device="cpu",
                       img_size=56, patch_size=8, num_classes=NCLS)
    held = cls.state_dict()
    enc = lp.encoder_state_from_checkpoint(step, ATTO[0])
    assert all(torch.equal(held[k], v) for k, v in enc.items())
    fresh = FCMAE(img_size=56, patch_size=8, depths=ATTO[0], dims=ATTO[1],
                  decoder_embed_dim=64, inp_modalities=JM.INP_MODALITIES,
                  out_modalities=JM.OUT_MODALITIES)
    visualize.load_fcmae(fresh, step)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_finetune_resume_carries_ema_and_batch_stats(tmp_path):
    """A ResNet finetune state (two stages of one block: the layout of every
    ResNet) with an EMA and BatchNorm statistics, saved by ``CheckpointIO``
    at epoch 2, resumed by ``pretrain.resume`` (the finetune driver's):
    params, running statistics, EMA and AdamW state as JAX holds them."""
    tm = ResNet((1, 1), BasicBlock, num_classes=NCLS, in_chans=3)
    tm.init_weights(torch.Generator().manual_seed(0))
    sd = {k: v.numpy().copy() for k, v in tm.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = torch_resnet_to_flax(sd, (1, 1), False)
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map(lambda a: jnp.asarray(
        rng.uniform(0.5, 1.5, size=np.shape(a)).astype(np.float32)), stats)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    ema = jax.tree_util.tree_map(lambda a: a * 0.5 + 0.01, params)
    tx = joptim.make_finetune_optimizer(params, jax_warmup_cosine(*SCHED), 0.05,
                                        clip_grad=1.0, opt="adamw")
    state = TrainState.create(params, tx, model_state={"batch_stats": stats}, ema_params=ema)
    g = jax.tree_util.tree_map(lambda p: jnp.asarray(
        (0.01 * rng.normal(size=p.shape)).astype(np.float32)), params)
    state = jax.jit(lambda s, g: s.apply_gradients(g))(state, g)
    io = jorbax.CheckpointIO(tmp_path)
    io.save(2, state)
    io.wait()

    named = list(tm.named_parameters())
    port = toptim.Optimizer(named, warmup_cosine(*SCHED), 0.05, (0.9, 0.999), clip_grad=1.0,
                            wd_mask=toptim.finetune_wd_mask(named))
    mine = init_ema(tm)
    run = tconfig.RunConfig(output_dir=str(tmp_path), auto_resume=True)
    assert pretrain.resume(run, tm, port, tmp_path, mine) == 3
    to_port = convert.params_converter(tm, np_tree(stats))
    want = to_port(np_tree(state.params))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, want[k].reshape(v.shape).to(v.dtype)), k
    want_ema = to_port(np_tree(ema))
    for k, v in mine.items():
        assert torch.equal(v, want_ema[k].reshape(v.shape)), k
    ref = _jax_opt_as_port(state, port, to_port)
    assert port.count == ref["count"] == 1
    for name, t in zip(port.names, port.slots["mu"]):
        assert torch.equal(t, ref["mu"][name]), name


# ---------------------------------------------------------------------------
# the grain position
# ---------------------------------------------------------------------------
class _Toy:
    def __init__(self, n):
        self.n, self.ids = n, [str(i) for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"x": np.full((2,), i, np.float32)}


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_grain_epoch_boundary_maps_and_mid_epoch_is_refused(tmp_path, shard):
    """JAX's grain position at the end of epoch 1 becomes the port's stream
    at the start of epoch 2; one batch into an epoch is refused, and so is
    another shard's position."""
    pack = tmp_path / "pack"
    jgp.pack_arrayrecord(_Toy(21), pack, shard_size=16)
    jl = jgp.GrainLoader(pack, batch_size=4, seed=3, shard=shard)
    it = jl.iterator()
    for _ in range(2 * len(jl)):
        next(it)
    boundary = jl.get_state()
    next(it)
    mid = jl.get_state()
    port = tgp.GrainLoader(pack, batch_size=4, seed=3, shard=shard)
    state = json.loads(orbax_io.loader_position(boundary, 1, port))
    assert state == {"epoch": 2, "pos": 0, "seed": 3, "shard": list(shard)}
    port.set_state(json.dumps(state).encode())
    first = next(port.iterator())["x"][:, 0]
    keys = port._order(3 + 2)[:4]
    assert np.array_equal(first, keys.astype(np.float32))
    with pytest.raises(ValueError, match="only an epoch boundary"):
        orbax_io.loader_position(mid, 2, port)
    other = tgp.GrainLoader(pack, batch_size=4, seed=3, shard=(shard[0] ^ 1, 2))
    with pytest.raises(ValueError, match="this loader reads shard"):
        orbax_io.loader_position(boundary, 1, other)


# ---------------------------------------------------------------------------
# the committed fixture
# ---------------------------------------------------------------------------
def test_committed_fixture_reads_as_jax_reads_it():
    """JAX's ``load_params`` and the port's reader agree bit for bit on the
    committed fixture, and each leaf matches its recorded checksum."""
    step = fx.FIXTURE / "checkpoints" / str(fx.CONFIG["epoch"])
    record = json.loads((fx.FIXTURE / "expected.json").read_text())
    got = orbax_io.load_tree(step)
    ref = jax.tree_util.tree_map(np.asarray, jorbax.load_params(step / "default"))
    _assert_bit_equal(got, ref)
    assert fx.leaf_digests(got) == record["leaves"]
    assert record["config"] == fx.CONFIG
    size = sum(p.stat().st_size for p in fx.FIXTURE.rglob("*") if p.is_file())
    assert size <= 2 * 1024 * 1024


def test_staged_seg_run_resumes_from_jaxs_orbax_past_its_unfreeze(seg_case, monkeypatch,
                                                                   tmp_path):
    """A JAX U-Net probe state past its unfreeze (every param training under
    the unfrozen AdamW, 2 updates), saved by ``CheckpointIO`` as epoch 1.
    ``run_finetune`` in that output directory with nothing left to train
    scores the final test on the step read from disk, its model holding
    JAX's params and its unfrozen optimizer JAX's AdamW state (the port's
    divergence: JAX would unfreeze anew); with one epoch more it trains
    epoch 2 from there and writes ``checkpoint-2.pth``."""
    import dataclasses

    from mmearth_tpu.checkpoints.torch_convert import torch_unet_to_flax

    monkeypatch.setattr(tft, "model_size", lambda name: (UNET_DEPTHS, UNET_DIMS))
    base = _seg_cfg(seg_case)
    model = tft.build_finetune_model(base, 12, gb.NUM_CLASSES[base.data_set])
    params = jax.tree_util.tree_map(jnp.asarray, torch_unet_to_flax(
        {k: v.numpy().copy() for k, v in model.state_dict().items()}, UNET_DEPTHS))
    tx = joptim.make_finetune_optimizer(params, jax_warmup_cosine(*SCHED), 0.3, (0.9, 0.999),
                                        0.9, "single", UNET_DEPTHS,
                                        trainable_mask=joptim.zero_grads_mask(params,
                                                                              lambda n: True))
    state = TrainState.create(params, tx)
    rng = np.random.default_rng(2)
    step = jax.jit(lambda s, g: s.apply_gradients(g))
    for _ in range(2):
        state = step(state, jax.tree_util.tree_map(lambda p: jnp.asarray(
            (0.01 * rng.normal(size=p.shape)).astype(np.float32)), params))
    out = tmp_path / "out"
    io = jorbax.CheckpointIO(out)
    io.save(1, state)
    io.wait()
    run = tconfig.RunConfig(epochs=2, seed=0, use_bf16=False, loss_aggr="unweighted",
                            output_dir=str(out))
    held = tft.run_finetune(dataclasses.replace(base, run=run), device="cpu")
    assert held["history"] == [] and held["test_params_from"] == "disk (epoch 1)"
    model, opt = held["model"], held["optimizer"]
    to_port = convert.params_converter(model)
    want = to_port(np_tree(state.params))
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k].reshape(v.shape)), k
    ref = _jax_opt_as_port(state, opt, to_port)
    assert opt.count == ref["count"] == 2
    assert len(opt.names) == sum(1 for n, _ in model.named_parameters()
                                 if not n.startswith("norm."))
    for name, t in zip(opt.names, opt.slots["nu"]):
        assert torch.equal(t, ref["nu"][name]), name
    more = tft.run_finetune(dataclasses.replace(base, run=dataclasses.replace(run, epochs=3)),
                            device="cpu")
    assert [e["epoch"] for e in more["history"]] == [2]
    assert more["optimizer"].count == 2 + N_TRAIN // base.batch_size
    assert pth_io.latest_checkpoint(out) == out / "checkpoint-2.pth"

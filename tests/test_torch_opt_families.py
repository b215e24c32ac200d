"""The port's ``--opt`` families (``train/optim.py::Optimizer``) against the
JAX package's ``make_finetune_optimizer`` (optax) on the CPU: 5 f32 steps of
the same params and grads (carried across by the port's converter) under a
weight-decay mask, layer decay 0.75, a clip at global norm 1, ``update_freq``
2 and a frozen stem, for every name; Adafactor's factored statistics where a
param's dims tie; LAMB's small head at the finetune recipe against JAX's
whole finetune step; the names JAX refuses; ``main_finetune --opt sgd`` on
the CPU, whose resume restores the momentum."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmearth_tpu.losses import finetune as jloss
from mmearth_tpu.train import optim as joptim
from mmearth_tpu.train.finetune import make_finetune_step
from mmearth_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
from mmearth_tpu.train.step import TrainState
from mmearth_tpu_torch import main_finetune
from mmearth_tpu_torch.checkpoints import pth_io
from mmearth_tpu_torch.checkpoints.convert import from_jax_classifier
from mmearth_tpu_torch.data import geobench as gb
from mmearth_tpu_torch.losses.finetune import criterion_fn
from mmearth_tpu_torch.models.fcmae import FCMAE
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train.finetune import finetune_step
from mmearth_tpu_torch.train.schedule import warmup_cosine

from _torch_parity import np_tree
from test_torch_finetune import DEPTHS, _classifier

NAMES = ["adamw", "adam", "nadam", "radam", "sgd", "nesterov", "momentum", "adadelta",
         "adafactor", "rmsprop", "rmsproptf", "novograd", "nvnovograd", "lamb", "fusedlamb"]
# base lr, min lr, epochs, warmup epochs, updates an epoch.  The tolerance
# is relative to each param's scale (the head's is ~0.03), so the lr keeps
# an update well under it: JAX rounds Adam's bias correction 1 - 0.999^t to
# f32 (1.3e-5 relative at t = 1) where the port takes it from the host in
# f64, a difference of ~1e-5 of an update
SCHED = (1e-3, 1e-6, 4, 1, 2)
STEPS, UPDATE_FREQ = 5, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frozen(name: str) -> bool:
    """The stem: ``initial_conv*`` / ``stem*`` in both layouts."""
    return name.startswith(("initial_conv", "stem"))


def _jax_steps(params, grads, opt, **kw):
    tx = joptim.make_finetune_optimizer(
        params, jax_warmup_cosine(*SCHED), 0.05, (0.9, 0.999), kw.get("layer_decay", 0.75),
        "single", DEPTHS, trainable_mask=joptim.zero_grads_mask(params, lambda p: not _frozen(p)),
        update_freq=UPDATE_FREQ, clip_grad=1.0, opt=opt, opt_eps=1e-8, momentum=0.9)
    state, update = tx.init(params), jax.jit(tx.update)
    for g in grads:
        updates, state = update(g, state, params)
        params = optax.apply_updates(params, updates)
    return params


@pytest.mark.parametrize("opt", NAMES)
def test_five_steps_match_jax(opt):
    tm, _, params = _classifier(seed=5)
    rng = np.random.default_rng(11)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray((0.05 * rng.normal(size=p.shape)).astype(np.float32)), params)
        for _ in range(STEPS)]
    ref = from_jax_classifier(np_tree(_jax_steps(params, grads, opt)), DEPTHS)

    init = {k: v.clone() for k, v in tm.state_dict().items()}
    for name, p in tm.named_parameters():
        p.requires_grad_(not _frozen(name))
    named = [(n, p) for n, p in tm.named_parameters() if p.requires_grad]
    optimizer = toptim.Optimizer(
        named, warmup_cosine(*SCHED), 0.05, (0.9, 0.999), eps=1e-8, update_freq=UPDATE_FREQ,
        clip_grad=1.0, wd_mask=toptim.finetune_wd_mask(named),
        lr_scales=toptim.layer_lr_scales(named, 0.75, DEPTHS), opt=opt, momentum=0.9)
    params_of = dict(tm.named_parameters())
    for g in grads:
        sd = from_jax_classifier(np_tree(g), DEPTHS)
        for name, p in named:
            p.grad = sd[name].reshape(p.shape).clone()
        optimizer.step()
    assert optimizer.count == STEPS // UPDATE_FREQ and optimizer.mini_step == 1
    moved = 0
    for name, v in params_of.items():
        want = ref[name].reshape(v.shape).numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(v.detach().numpy(), want, rtol=1e-5, atol=1e-6 * scale,
                                   err_msg=f"{opt} {name}")
        if _frozen(name):
            assert torch.equal(v.detach(), init[name]), name
        else:
            moved += not torch.equal(v.detach(), init[name])
    assert moved == len(named)


def test_adafactor_factors_tied_dims_in_jaxs_order():
    """Adafactor factors over the two largest dims (>= 128), ties broken in
    flax's axis order: a (128, 128) Linear (flax's (in, out) transposed), a
    1x1 conv of 128 -> 128 (OIHW against HWIO), and a (256, 128) Linear
    whose larger dim is flax's last, each 3 steps against optax."""
    rng = np.random.default_rng(3)
    flax = {"lin": {"kernel": rng.normal(size=(128, 128))},
            "conv": {"kernel": rng.normal(size=(1, 1, 128, 128))},
            "wide": {"kernel": rng.normal(size=(128, 256))},
            "bias": {"bias": rng.normal(size=(128,))}}
    flax = jax.tree_util.tree_map(lambda a: jnp.asarray(a.astype(np.float32)), flax)
    to_port = {"lin.weight": lambda a: a.T, "conv.weight": lambda a: a.transpose(3, 2, 0, 1),
               "wide.weight": lambda a: a.T, "bias.bias": lambda a: a}
    keys = {"lin.weight": ("lin", "kernel"), "conv.weight": ("conv", "kernel"),
            "wide.weight": ("wide", "kernel"), "bias.bias": ("bias", "bias")}
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)), flax)
        for _ in range(3)]
    tx = joptim.make_finetune_optimizer(flax, lambda n: 0.1, 0.0, opt="adafactor")
    state, want = tx.init(flax), flax
    for g in grads:
        updates, state = tx.update(g, state, want)
        want = optax.apply_updates(want, updates)

    def port(tree, name):
        a, b = keys[name]
        return torch.from_numpy(np.array(to_port[name](np.asarray(tree[a][b]))))

    params = {n: torch.nn.Parameter(port(flax, n)) for n in keys}
    opt = toptim.Optimizer(params.items(), lambda n: 0.1, 0.0, (0.9, 0.999), opt="adafactor")
    assert toptim.factored_dims(params["lin.weight"].shape) == (1, 0)
    assert toptim.factored_dims(params["conv.weight"].shape) == (1, 0)
    assert toptim.factored_dims(params["wide.weight"].shape) == (1, 0)
    assert toptim.factored_dims(params["bias.bias"].shape) is None
    assert opt.slots["v_row"][0].shape == (128,) and opt.slots["v"][0].shape == (1,)
    for g in grads:
        for n, p in params.items():
            p.grad = port(g, n)
        opt.step()
    for n, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), port(want, n).numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_lamb_keeps_the_small_head_near_zero_as_jaxs_does():
    """The finetune recipe's LAMB (head init scale 0.001, layer decay 0.9,
    weight decay 0.3, smoothing 0.2) for 5 steps, the port's classifier
    against JAX's ``make_finetune_step`` on the same weights and batches:
    the losses and the head's norm agree within the file's tolerances, and
    on both sides the head stays within 10% of its initial norm and the
    loss near ln 10.  LAMB's trust ratio scales a leaf's step by its own
    norm, so a head that starts near 0 moves by a small fraction of its
    norm a step (not a fault of the port)."""
    tm, jm, params = _classifier(seed=4, head_init_scale=0.001)
    rng = np.random.default_rng(12)
    batches = [{"input": rng.normal(size=(4, 56, 56, 12)).astype(np.float32),
                "label": rng.integers(0, 10, size=(4,)).astype(np.int32)} for _ in range(STEPS)]
    head0 = float(tm.head.weight.detach().norm())
    tx = joptim.make_finetune_optimizer(params, jax_warmup_cosine(*SCHED), 0.3, (0.9, 0.999),
                                        0.9, "single", DEPTHS, opt="lamb")
    state = TrainState.create(params, tx)
    step_fn = jax.jit(make_finetune_step(jm, jloss.criterion_fn("m-eurosat", 0.2), False))
    want = []
    for b in batches:
        state, metrics = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()},
                                 jax.random.PRNGKey(0))
        want.append(float(metrics["loss"]))
    named = list(tm.named_parameters())
    opt = toptim.Optimizer(named, warmup_cosine(*SCHED), 0.3, (0.9, 0.999),
                           wd_mask=toptim.finetune_wd_mask(named),
                           lr_scales=toptim.layer_lr_scales(named, 0.9, DEPTHS), opt="lamb")
    gen = torch.Generator().manual_seed(0)
    got = [float(finetune_step(tm, opt, {k: torch.from_numpy(v) for k, v in b.items()},
                               criterion_fn("m-eurosat", 0.2), gen)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    head = float(tm.head.weight.detach().norm())
    jax_head = float(np.linalg.norm(np.asarray(state.params["head"]["kernel"])))
    np.testing.assert_allclose(head, jax_head, rtol=1e-5)
    for norm in (head, jax_head):
        assert abs(norm / head0 - 1) < 0.1, (norm, head0)
    np.testing.assert_allclose([*got, *want], math.log(10), atol=1e-3)


@pytest.mark.parametrize("opt", ["adamp", "sgdp", "adahessian", "fusedadamp", "bogus"])
def test_unsupported_names_raise_as_jaxs(opt):
    with pytest.raises(ValueError, match="not supported"):
        joptim._opt_scaler(opt, (0.9, 0.999), 1e-8, 0.9)
    with pytest.raises(ValueError, match="not supported"):
        toptim.Optimizer([("w", torch.nn.Parameter(torch.zeros(2)))], lambda n: 0.1, opt=opt)


def test_state_dict_round_trips_and_refuses_another_family():
    p = torch.nn.Parameter(torch.ones(3, 2))
    opt = toptim.Optimizer([("w", p)], lambda n: 0.1, opt="rmsprop", update_freq=2)
    for _ in range(3):
        p.grad = torch.full((3, 2), 0.5)
        opt.step()
    state = opt.state_dict()
    assert state["opt"] == "rmsprop" and set(state) == {"nu", "trace", "acc", "opt", "count",
                                                        "mini_step"}
    other = toptim.Optimizer([("w", torch.nn.Parameter(torch.ones(3, 2)))], lambda n: 0.1,
                             opt="rmsproptf", update_freq=2)
    other.load_state_dict(state)
    assert torch.equal(other.slots["trace"][0], opt.slots["trace"][0]) and other.count == 1
    with pytest.raises(ValueError, match="--opt sgd"):
        toptim.Optimizer([("w", p)], lambda n: 0.1, opt="sgd", update_freq=2).load_state_dict(
            state)


@pytest.fixture(scope="module")
def eurosat(tmp_path_factory):
    d = tmp_path_factory.mktemp("geobench_opt")
    gb.generate_synthetic_geobench(d, "m-eurosat", (12, 4, 4))
    fc = FCMAE(img_size=56, patch_size=8, depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
    torch.save({"model": fc.init_weights(torch.Generator().manual_seed(0)).state_dict()},
               d / "pt.pth")
    return d


def _args(d, out, *extra):
    return main_finetune.get_args_parser().parse_args([
        "--device", "cpu", "--model", "convnextv2_atto", "--input_size", "56",
        "--patch_size", "8", "--processed_dir", str(d), "--finetune", str(d / "pt.pth"),
        "--batch_size", "4", "--epochs", "2", "--blr", "2e-2", "--layer_decay", "0.9",
        "--weight_decay", "0.3", "--drop_path", "0.1", "--smoothing", "0.2", "--opt", "sgd",
        "--output_dir", str(out), "--use_bf16", "False", *extra])


def test_main_finetune_opt_sgd_resumes_its_momentum(eurosat, tmp_path):
    """Two epochs of ``--opt sgd``; then the second again, resumed from the
    first's checkpoint with its momentum trace: the same losses and params."""
    whole = main_finetune.main(_args(eurosat, tmp_path / "a"))
    ckpt = tmp_path / "a" / "checkpoint-0.pth"
    saved = pth_io.load(ckpt)["optimizer"]
    assert saved["opt"] == "sgd" and saved["count"] == 3
    assert all(float(t.abs().max()) > 0 for t in saved["trace"].values())
    rest = main_finetune.main(_args(eurosat, tmp_path / "b", "--resume", str(ckpt)))
    assert [e["epoch"] for e in rest["history"]] == [1]
    assert rest["optimizer"].opt == "sgd" and rest["optimizer"].count == 6
    np.testing.assert_array_equal(rest["history"][0]["step_losses"],
                                  whole["history"][1]["step_losses"])
    for k, v in whole["model"].state_dict().items():
        assert torch.equal(v, rest["model"].state_dict()[k]), k
    assert all(math.isfinite(x) for x in rest["history"][0]["step_losses"])

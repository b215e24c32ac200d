"""The port's ResNet baselines against the JAX package on the CPU: ResNet-18/50
and the ResNet-UNet in train mode (logits, every grad and the BatchNorm
running statistics after the step) and in eval mode, the torchvision key
order, the four foreign remaps, ``load_foreign_resnet`` from a ``.pth``,
the layer-decay scales, a ResNet-UNet probe step, and the bootstrap.  32-px
inputs, seeded numpy data; each tolerance is stated where it is used.

JAX runs in f64 here.  flax's BatchNorm takes the variance as E[x^2] -
E[x]^2, whose gradient cancels badly in f32 where a deep layer sees few
values a channel (batch 3 at 1x1): there the port's f32 gradients stray
from its f64 ones by up to 0.2% of their scale (36% for a ResNet-50 at 64
px and batch 4), and JAX's f32 ones, on the CPU, by 11% even where the
port's stay within 1e-5.  So the port is held in f64 against JAX's f64
(the same function, tightly), and in f32 on the ResNet-18 at 64 px and
batch 4, where its f32 gradients lie within 1e-5 of the f64 ones.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.checkpoints import foreign as JF
from mmearth_tpu.checkpoints import load_pretrained as jlp
from mmearth_tpu.losses import finetune as jloss
from mmearth_tpu.models import resnet as jres
from mmearth_tpu.train import optim as joptim
from mmearth_tpu.train.finetune import make_finetune_step
from mmearth_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
from mmearth_tpu.train.step import TrainState
from mmearth_tpu_torch.checkpoints import foreign as F
from mmearth_tpu_torch.checkpoints import load_pretrained as lp
from mmearth_tpu_torch.checkpoints.convert import from_jax_resnet
from mmearth_tpu_torch.configs.config import FinetuneConfig, ModelConfig, RunConfig
from mmearth_tpu_torch.losses import finetune as loss_lib
from mmearth_tpu_torch.models.resnet import build_resnet, resnet_spec, same_pads
from mmearth_tpu_torch.train import finetune as tft
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train.schedule import warmup_cosine

from _torch_parity import close, np_tree
from test_baselines import fake_torch_resnet_sd

RTOL = 1e-4  # f32 sums in another order, relative to each tensor's largest magnitude
NCLS = 5
SPEC = {"resnet18": ((2, 2, 2, 2), False), "resnet50": ((3, 4, 6, 3), True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(name, in_chans=3):
    """The JAX model computing in f64 (under ``jax.enable_x64``; its params
    are f32)."""
    build = {"resnet18": jres.resnet18, "resnet50": jres.resnet50,
             "resnet18_unet": jres.resnet18_unet, "resnet50_unet": jres.resnet50_unet}[name]
    return build(num_classes=NCLS, in_chans=in_chans, dtype=jnp.float64)


def _randomize_bn(params, stats, seed):
    """Non-trivial BatchNorm: scales around 1 (JAX zero-inits each block's
    last, which would hide the residual branch), random biases, running
    means and variances."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[-1] == "scale":
            return jnp.asarray(1.0 + 0.3 * rng.normal(size=leaf.shape), jnp.float32)
        if keys[-1] == "bias" and any("norm" in k or "BatchNorm" in k for k in keys):
            return jnp.asarray(0.2 * rng.normal(size=leaf.shape), jnp.float32)
        if keys[-1] == "mean":
            return jnp.asarray(0.1 * rng.normal(size=leaf.shape), jnp.float32)
        if keys[-1] == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, size=leaf.shape), jnp.float32)
        return leaf

    return (jax.tree_util.tree_map_with_path(fix, params),
            jax.tree_util.tree_map_with_path(fix, stats))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _case(name, seed=0, size=32, dtype=torch.float32):
    """The JAX model, its params and batch stats, and the port's model
    holding them, computing in ``dtype``."""
    jm = _jax_model(name)
    with jax.enable_x64(True):
        v = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)))
    params, stats = _randomize_bn(v["params"], v["batch_stats"], seed)
    stage_sizes, bottleneck = resnet_spec(name)
    tm = build_resnet(name, num_classes=NCLS, in_chans=3, dtype=dtype)
    tm.load_state_dict(from_jax_resnet(np_tree(params), np_tree(stats), stage_sizes, bottleneck),
                       strict=True)
    return tm.to(dtype), jm, params, stats


def test_same_pads_are_tf_same():
    """TF-style SAME: stride 2 on an even side pads less before than after."""
    assert same_pads(64, 7, 2) == (2, 3)
    assert same_pads(32, 3, 2) == (0, 1)
    assert same_pads(7, 3, 2) == (1, 1)
    assert same_pads(32, 3, 1) == (1, 1)
    assert same_pads(32, 1, 2) == (0, 0)


@pytest.mark.parametrize("name,size,n,dtype,rtol", [
    ("resnet18", 32, 3, torch.float64, 1e-6), ("resnet50", 32, 3, torch.float64, 1e-6),
    ("resnet18_unet", 32, 3, torch.float64, 1e-6), ("resnet50_unet", 32, 3, torch.float64, 1e-6),
    ("resnet18", 64, 4, torch.float32, RTOL)])
def test_resnet_train_step_matches_jax(name, size, n, dtype, rtol):
    """Train mode: the logits (or per-pixel logits) and every param grad
    against JAX ``apply(train=True, mutable=["batch_stats"])`` within
    ``rtol`` of the scale (f64: sums in another order, amplified by the
    variance's cancellation), and the running statistics after the step
    within 1e-5 (flax's momentum 0.9 over the biased variance)."""
    rng = np.random.default_rng(len(name))
    x = rng.normal(size=(n, size, size, 3))
    seg = "unet" in name
    r = rng.normal(size=(n, size, size, NCLS) if seg else (n, NCLS))
    tm, jm, params, stats = _case(name, seed=1, size=size, dtype=dtype)

    with jax.enable_x64(True):
        def loss(p):
            out, mutated = jm.apply({"params": p, "batch_stats": _f64(stats)},
                                    jnp.asarray(x, jnp.float64), train=True,
                                    mutable=["batch_stats"])
            return jnp.sum(out * r), (out, mutated["batch_stats"])

        (_, (ref, new_stats)), g_ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            _f64(params))
        ref, new_stats, g_ref = np.asarray(ref), np_tree(new_stats), np_tree(g_ref)
    tm.train()
    out = tm(torch.from_numpy(x).to(dtype))
    (out * torch.from_numpy(r).to(dtype)).sum().backward()
    close(out.detach().numpy(), ref, "logits", rtol)
    stage_sizes, bottleneck = resnet_spec(name)
    want = from_jax_resnet(g_ref, new_stats, stage_sizes, bottleneck)
    seen = 0
    for k, prm in tm.named_parameters():
        close(prm.grad.numpy(), want[k].reshape(prm.shape).numpy(), k, rtol)
        seen += 1
    assert seen == len(list(tm.parameters()))
    for k, buf in tm.named_buffers():
        if k.endswith("num_batches_tracked"):
            assert int(buf) == 1, k
        else:
            np.testing.assert_allclose(buf.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("name", ["resnet18", "resnet18_unet"])
def test_resnet_eval_matches_jax(name):
    """Eval mode normalises with the running statistics and leaves them as
    they are: the output against JAX ``apply(train=False)`` (f64) within
    ``RTOL``."""
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    tm, jm, params, stats = _case(name, seed=3, size=64)
    before = {k: v.clone() for k, v in tm.named_buffers()}
    with jax.enable_x64(True):
        ref = np.asarray(jm.apply({"params": _f64(params), "batch_stats": _f64(stats)},
                                  jnp.asarray(x, jnp.float64), train=False))
    tm.eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    close(out.numpy(), ref, "eval logits", RTOL)
    assert all(torch.equal(v, before[k]) for k, v in tm.named_buffers())


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_state_dict_keys_are_torchvision_order(name):
    """The port's ResNet has ``torch_resnet_sd_keys``' keys in their order
    (the JAX package's list and the port's copy), and the ResNet-UNet has
    them under ``encoder.``."""
    stage_sizes, bottleneck = SPEC[name]
    keys = JF.torch_resnet_sd_keys(stage_sizes, bottleneck)
    assert F.torch_resnet_sd_keys(stage_sizes, bottleneck) == keys
    assert list(build_resnet(name, num_classes=NCLS).state_dict()) == keys
    unet = build_resnet(f"{name}_unet", num_classes=NCLS).state_dict()
    assert [k[len("encoder."):] for k in unet if k.startswith("encoder.")] == keys[:-2]


def _foreign_dicts(stage_sizes, bottleneck):
    """A torchvision-shaped state dict and its SeCo, GASSL and Satlas forms,
    as ``tests/test_baselines.py`` builds them."""
    base = fake_torch_resnet_sd(stage_sizes, bottleneck, seed=1)
    backbone = {k: v for k, v in base.items() if not k.startswith("fc.")}
    seco = {f"encoder_q.{k}": v for k, v in backbone.items()}
    seco["encoder_k.conv1.weight"] = np.zeros((64, 3, 7, 7), np.float32)
    seco["queue"] = np.zeros((128, 4), np.float32)
    seco["queue_ptr"] = np.asarray(0)
    seco["heads.0.weight"] = np.zeros((4, 4), np.float32)
    gassl = {"state_dict": {f"module.backbone.{k}": v for k, v in backbone.items()}}
    gassl["state_dict"]["module.encoder_k.conv1.weight"] = np.zeros((64, 3, 7, 7), np.float32)
    satlas = {f"backbone.resnet.{i}": v for i, v in enumerate(backbone.values())}
    return {"seco": seco, "gassl": gassl, "satlas": satlas, "imnet": base}


@pytest.mark.parametrize("bottleneck", [False, True])
@pytest.mark.parametrize("source", ["seco", "gassl", "satlas", "imnet"])
def test_remap_foreign_matches_jax(source, bottleneck):
    """Each remap, dispatched on the path as upstream does, gives JAX
    ``remap_foreign``'s keys in its order and its arrays."""
    stage_sizes = (3, 4, 6, 3) if bottleneck else (2, 2, 2, 2)
    sd = _foreign_dicts(stage_sizes, bottleneck)[source]
    path = f"/ckpts/{source}_resnet.pth"
    ours = F.remap_foreign(sd, path, stage_sizes, bottleneck)
    ref = JF.remap_foreign(sd, path, stage_sizes, bottleneck)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(ours[k]), ref[k], err_msg=k)
    assert "fc.weight" not in ours


@pytest.mark.parametrize("source", ["seco", "gassl", "satlas"])
def test_load_foreign_resnet_matches_jax(source, tmp_path):
    """``load_foreign_resnet`` on a ``.pth`` of tensors (GASSL wrapped in
    ``state_dict``) gives what JAX's loader gives, carried into torchvision
    keys: every value bit-identical; it loads into the port's ResNet."""
    stage_sizes, bottleneck = (2, 2, 2, 2), False
    sd = _foreign_dicts(stage_sizes, bottleneck)[source]
    if source == "gassl":
        sd = sd["state_dict"]
        payload = {"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}
    else:
        payload = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    path = tmp_path / f"{source}_r18.pth"
    torch.save(payload, path)
    ours = F.load_foreign_resnet(path, stage_sizes, bottleneck)
    params, stats = JF.load_foreign_resnet(str(path), stage_sizes, bottleneck)
    ref = from_jax_resnet(params, stats, stage_sizes, bottleneck)
    assert list(ours) == [k for k in ref if not k.startswith("fc.")]
    for k, v in ours.items():
        if k.endswith("num_batches_tracked"):
            assert v.dtype == torch.long
        else:
            assert torch.equal(v, ref[k]), k
    model = build_resnet("resnet18", num_classes=NCLS)
    model.load_state_dict(lp.load_encoder_into(model.state_dict(), ours))


@pytest.mark.parametrize("name", ["resnet18", "resnet18_unet"])
def test_resnet_layer_scales_match_jax(name):
    """Every ResNet param takes the top layer id, as in JAX (torchvision's
    ``layer1.0...``/``downsample`` names parse as neither a stage nor a
    downsample): each lr scale is 1 under both schemes, as JAX's."""
    tm, _, params, stats = _case(name)
    named = list(tm.named_parameters())
    stage_sizes, bottleneck = resnet_spec(name)
    for kind in ("single", "group"):
        ref = from_jax_resnet(jax.tree_util.tree_map(
            lambda m, p: np.full(np.shape(p), m, np.float32),
            joptim.layer_lr_scales(params, 0.9, (2, 2, 2, 2), kind), params), np_tree(stats),
            stage_sizes, bottleneck)
        scales = toptim.layer_lr_scales(named, 0.9, (2, 2, 2, 2), kind)
        assert set(scales.values()) == {1.0}
        assert all(float(ref[k].reshape(-1)[0]) == v for k, v in scales.items())
    for n in ("layer2.0.downsample.0.weight", "encoder.layer1.0.conv1.weight", "decoder.0.conv0"):
        assert toptim._stage_block(n)[0] == "other"


@pytest.mark.parametrize("probe", [False, True])
def test_resnet_unet_steps_match_jax(probe):
    """2 f64 updates of the ResNet-18 U-Net (BN in train mode, layer decay
    0.9, wd 0.3) against JAX's ``make_finetune_step(has_batch_stats=True)``:
    each loss within 1e-6 relative (the criterion computes in f32, so the
    grads carry f32 rounding), the params within 2e-5 absolute + 1e-4
    relative (Adam's first updates move a param by ~lr whatever |g|), the
    running statistics within 1e-8 absolute + 1e-6 relative (the reference
    rounded to f32).  The probe trains all but
    the encoder, whose params stay bit-identical while its running
    statistics move (train-mode BN), as in JAX."""
    rng = np.random.default_rng(5)
    batches = [{"input": rng.normal(size=(2, 32, 32, 3)).astype(np.float32),
                "label": rng.integers(0, NCLS, size=(2, 32, 32)).astype(np.int32)}
               for _ in range(2)]
    tm, jm, params, stats = _case("resnet18_unet", seed=4, dtype=torch.float64)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    sched_args = (1e-2, 1e-6, 4, 1, 2)
    jtrain = (lambda p: not p.startswith("encoder")) if probe else jlp.all_trainable
    with jax.enable_x64(True):
        tx = joptim.make_finetune_optimizer(
            _f64(params), jax_warmup_cosine(*sched_args), 0.3, (0.9, 0.999), 0.9, "single",
            (2, 2, 2, 2), trainable_mask=joptim.zero_grads_mask(params, jtrain))
        state = TrainState.create(_f64(params), tx, model_state={"batch_stats": _f64(stats)})
        step_fn = jax.jit(make_finetune_step(jm, jloss.criterion_fn("m-cashew-plant", 0.0), True,
                                             has_batch_stats=True))
        ref_losses = []
        for b in batches:
            state, m = step_fn(state, {"input": jnp.asarray(b["input"], jnp.float64),
                                       "label": jnp.asarray(b["label"])}, jax.random.PRNGKey(0))
            ref_losses.append(float(m["loss"]))
        ref = from_jax_resnet(np_tree(state.params), np_tree(state.model_state["batch_stats"]),
                              (2, 2, 2, 2), False)

    trainable = lp.resnet_unet_probe_trainable if probe else lp.all_trainable
    for name, prm in tm.named_parameters():
        prm.requires_grad_(trainable(name))
    named = [(k, p) for k, p in tm.named_parameters() if p.requires_grad]
    opt = toptim.AdamW(named, warmup_cosine(*sched_args), 0.3, (0.9, 0.999),
                       wd_mask=toptim.finetune_wd_mask(named),
                       lr_scales=toptim.layer_lr_scales(named, 0.9, (2, 2, 2, 2)))
    gen = torch.Generator().manual_seed(0)
    for b, ref_loss in zip(batches, ref_losses):
        batch = {"input": torch.from_numpy(b["input"]).double(),
                 "label": torch.from_numpy(b["label"])}
        loss = tft.finetune_step(tm, opt, batch, loss_lib.criterion_fn("m-cashew-plant", 0.0),
                                 gen)
        np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6)
    for k, v in tm.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = ((1e-6, 1e-8) if k.endswith(("running_mean", "running_var")) else (1e-4, 2e-5))
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=tol[0], atol=tol[1], err_msg=k)
        if probe and k.startswith("encoder.") and not k.endswith(("running_mean", "running_var")):
            assert torch.equal(v, init[k]), k
    assert not torch.equal(tm.state_dict()["encoder.bn1.running_mean"],
                           init["encoder.bn1.running_mean"])


@pytest.mark.parametrize("name", ["resnet18", "resnet18_unet"])
def test_bootstrap_matches_jax(name, tmp_path):
    """``train/finetune.py::bootstrap`` from a SeCo ``.pth`` against JAX's
    (``load_foreign_resnet`` -> ``load_encoder_into``, ``fc`` re-drawn for
    the classifier): the backbone and the head bit-identical."""
    stage_sizes, bottleneck = (2, 2, 2, 2), False
    sd = _foreign_dicts(stage_sizes, bottleneck)["seco"]
    path = tmp_path / "seco_r18.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    cfg = FinetuneConfig(model=ModelConfig(model=name), run=RunConfig(seed=3, use_bf16=False),
                         finetune=str(path))
    model = tft.build_finetune_model(cfg, 3, NCLS)
    tft.bootstrap(model, path, cfg.run.seed)

    with jax.enable_x64(True):
        v = _jax_model(name).init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    fparams, fstats = JF.load_foreign_resnet(str(path), stage_sizes, bottleneck)
    fparams.pop("fc", None)
    where = "encoder" if "unet" in name else ""
    params = jlp.load_encoder_into(v["params"], fparams, where=where)
    stats = jlp.load_encoder_into(v["batch_stats"], fstats, where=where)
    if not where:
        params = jlp.reinit_head(params, cfg.run.seed)
    ref = from_jax_resnet(np_tree(params), np_tree(stats), stage_sizes, bottleneck)
    ours = model.state_dict()
    keys = [k for k in ref if k.startswith(("encoder.", "fc.")) or not where]
    for k in keys:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(ours[k], ref[k]), k
    if not where:
        assert not ours["fc.bias"].any() and float(ours["fc.weight"].std()) < 1e-4

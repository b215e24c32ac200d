"""The port's GEO-Bench segmentation slice against the JAX package on the CPU:
the ConvNeXtV2 U-Net (both stems, patch 8 and 16), its converter against
JAX's ``flax_unet_to_torch``, a seg finetune step, the probe -> unfreeze
trajectory of ``run_finetune``, the U-Net's layer-decay scales and
``dice_loss``.  Small widths (depths 1/1/1/1, dims 8-32), 32-px inputs,
seeded numpy data, f32; each tolerance is stated where it is used.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.checkpoints import load_pretrained as jlp
from mmearth_tpu.checkpoints import torch_convert as jtc
from mmearth_tpu.configs import modalities as JM
from mmearth_tpu.data import geobench as jgb
from mmearth_tpu.losses import finetune as jloss
from mmearth_tpu.models import unet as junet
from mmearth_tpu.train import finetune as jft
from mmearth_tpu.train import optim as joptim
from mmearth_tpu.train.finetune import make_finetune_step
from mmearth_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
from mmearth_tpu.train.step import TrainState
from mmearth_tpu_torch.checkpoints import load_pretrained as lp
from mmearth_tpu_torch.checkpoints.convert import from_jax_unet
from mmearth_tpu_torch.configs.config import FinetuneConfig, ModelConfig, OptimConfig, RunConfig
from mmearth_tpu_torch.data import geobench as gb
from mmearth_tpu_torch.losses import finetune as loss_lib
from mmearth_tpu_torch.models.fcmae import FCMAE
from mmearth_tpu_torch.models.unet import ConvNeXtV2Unet, nearest_upsample
from mmearth_tpu_torch.train import finetune as tft
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train.schedule import warmup_cosine

from _torch_parity import assert_grads_close, close, np_tree, randomize_grn

DEPTHS, DIMS, NCLS = (1, 1, 1, 1), (8, 16, 24, 32), 7
RTOL = 1e-4  # f32 sums in another order, relative to each tensor's largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unet(patch_size=8, use_orig_stem=False, in_chans=12, seed=0):
    """The JAX U-Net, its params (JAX init, GRN affines randomized: they init
    to zero, which hides GRN bugs) and the port's U-Net holding them."""
    kw = dict(patch_size=patch_size, img_size=32, in_chans=in_chans, num_classes=NCLS,
              depths=DEPTHS, dims=DIMS, use_orig_stem=use_orig_stem, head_init_scale=0.5)
    jm = junet.ConvNeXtV2Unet(**kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 32, 32, in_chans)))["params"]
    params = randomize_grn(params, seed)
    tm = ConvNeXtV2Unet(**kw)
    tm.load_state_dict(from_jax_unet(np_tree(params), DEPTHS, use_orig_stem), strict=True)
    return tm, jm, params


def test_nearest_upsample_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 4)).astype(np.float32)
    for s in (1, 2, 4):
        np.testing.assert_array_equal(nearest_upsample(torch.from_numpy(x), s).numpy(),
                                      np.asarray(junet.nearest_upsample(jnp.asarray(x), s)))


@pytest.mark.parametrize("use_orig_stem", [False, True])
@pytest.mark.parametrize("patch_size", [8, 16])
def test_unet_matches_jax(patch_size, use_orig_stem):
    """Per-pixel logits and every param grad of the U-Net against JAX
    ``model.apply`` within ``RTOL`` of the scale; stem stride 1 at patch 8
    (a 1x1 stem, the last upsample a no-op) and 2 at patch 16."""
    rng = np.random.default_rng(patch_size + use_orig_stem)
    x = rng.normal(size=(2, 32, 32, 12)).astype(np.float32)
    r = rng.normal(size=(2, 32, 32, NCLS)).astype(np.float32)
    tm, jm, params = _unet(patch_size, use_orig_stem)
    assert tm.stem_stride == patch_size // 8

    @jax.jit
    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(logits * r), logits

    (_, ref), g_ref = jax.value_and_grad(loss, has_aux=True)(params)
    logits = tm(torch.from_numpy(x))
    assert logits.shape == (2, 32, 32, NCLS)
    (logits * torch.from_numpy(r)).sum().backward()
    close(logits.detach().numpy(), ref, "logits", RTOL)
    grads = from_jax_unet(np_tree(g_ref), DEPTHS, use_orig_stem)
    assert_grads_close(tm, {k: v for k, v in grads.items() if not k.startswith("norm.")}, RTOL)
    assert tm.norm.weight.grad is None  # upstream's final norm: registered, unused


@pytest.mark.parametrize("use_orig_stem", [False, True])
def test_from_jax_unet_matches_flax_unet_to_torch(use_orig_stem):
    """The port's converter emits JAX's export (``flax_unet_to_torch`` with
    ``dims``, the unused final norm included): the same keys, bit-identical
    values, each in the port's shape; the export strict-loads."""
    _, _, params = _unet(16, use_orig_stem)
    ours = from_jax_unet(np_tree(params), DEPTHS, use_orig_stem)
    ref = jtc.flax_unet_to_torch(params, DEPTHS, use_orig_stem, dims=DIMS)
    assert set(ours) == set(ref)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]).reshape(v.shape), err_msg=k)
    model = ConvNeXtV2Unet(patch_size=16, img_size=32, in_chans=12, num_classes=NCLS,
                           depths=DEPTHS, dims=DIMS, use_orig_stem=use_orig_stem)
    model.load_state_dict({k: torch.as_tensor(np.array(v)).reshape(ours[k].shape)
                           for k, v in ref.items()}, strict=True)
    with pytest.raises(ValueError, match="stem"):
        from_jax_unet(np_tree(params), DEPTHS, not use_orig_stem)


def _leafwise(tree_fn, params, use_orig_stem=False):
    """A JAX per-leaf decision as the port's state dict."""
    return from_jax_unet(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), tree_fn(params), params),
        DEPTHS, use_orig_stem)


@pytest.mark.parametrize("kind", ["single", "group"])
def test_unet_layer_scales_and_masks_match_jax(kind):
    """Per param: the layer-decay lr scale (decay 0.9), the finetune decay
    mask and the probe's trainable set equal JAX's; the decoder, the head
    and the stem take the top layer id."""
    tm, _, params = _unet()
    named = [(n, p) for n, p in tm.named_parameters() if lp.unet_trainable(n)]
    ref = _leafwise(lambda p: joptim.layer_lr_scales(p, 0.9, DEPTHS, kind), params)
    scales = toptim.layer_lr_scales(named, 0.9, DEPTHS, kind)
    for k, v in scales.items():
        np.testing.assert_allclose(v, float(ref[k].reshape(-1)[0]), rtol=1e-6, err_msg=k)
    for k in ("upsample_layers.0.conv.weight", "initial_conv_upsample.1.bias", "head.weight",
              "stem.0.weight"):
        assert scales[k] == 1.0, k
    assert scales["stages.0.0.dwconv.weight"] < 1.0
    ref_mask = _leafwise(joptim.finetune_wd_mask, params)
    assert toptim.finetune_wd_mask(named) == {k: bool(ref_mask[k].reshape(-1)[0]) for k, _ in named}
    ref_probe = _leafwise(lambda p: joptim.zero_grads_mask(p, jlp.unet_probe_trainable), params)
    assert {k: lp.unet_probe_trainable(k) for k, _ in named} == {
        k: bool(ref_probe[k].reshape(-1)[0]) for k, _ in named}


@pytest.mark.parametrize("probe", [False, True])
def test_seg_finetune_steps_match_jax(probe):
    """2 f32 updates of the U-Net on the segmentation criterion (layer decay
    0.9, wd 0.3, AdamW (0.9, 0.999), drop path 0) against JAX's
    ``make_finetune_optimizer`` + ``make_finetune_step(is_seg=True)``: each
    loss within 1e-5 relative, the params within 2e-5 absolute + 1e-4
    relative (Adam's first updates move a param by ~lr whatever |g|).  The
    probe trains the decoder and the head: every encoder param stays
    bit-identical."""
    rng = np.random.default_rng(11)
    batches = [{"input": rng.normal(size=(3, 32, 32, 12)).astype(np.float32),
                "label": rng.integers(0, NCLS, size=(3, 32, 32)).astype(np.int32)}
               for _ in range(2)]
    tm, jm, params = _unet(16, seed=2)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    sched_args = (1e-2, 1e-6, 4, 1, 2)
    trainable = lp.unet_probe_trainable if probe else lp.unet_trainable
    tx = joptim.make_finetune_optimizer(
        params, jax_warmup_cosine(*sched_args), 0.3, (0.9, 0.999), 0.9, "single", DEPTHS,
        trainable_mask=joptim.zero_grads_mask(
            params, jlp.unet_probe_trainable if probe else jlp.all_trainable))
    state = TrainState.create(params, tx)
    step_fn = jax.jit(make_finetune_step(jm, jloss.criterion_fn("m-cashew-plant", 0.0), True))
    ref_losses = []
    for b in batches:
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        ref_losses.append(float(m["loss"]))

    for name, prm in tm.named_parameters():
        prm.requires_grad_(trainable(name))
    named = [(k, p) for k, p in tm.named_parameters() if p.requires_grad]
    opt = toptim.AdamW(named, warmup_cosine(*sched_args), 0.3, (0.9, 0.999),
                       wd_mask=toptim.finetune_wd_mask(named),
                       lr_scales=toptim.layer_lr_scales(named, 0.9, DEPTHS))
    gen = torch.Generator().manual_seed(0)
    for b, ref_loss in zip(batches, ref_losses):
        loss = tft.finetune_step(tm, opt, {k: torch.from_numpy(v) for k, v in b.items()},
                                 loss_lib.criterion_fn("m-cashew-plant", 0.0), gen)
        np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    ref = from_jax_unet(np_tree(state.params), DEPTHS)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].reshape(v.shape).numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
        if probe and not lp.unet_probe_trainable(k):
            assert torch.equal(v, init[k]), k
    assert float((tm.head.weight.detach() - init["head.weight"]).abs().max()) > 1e-4


def test_dice_loss_matches_jax():
    """``dice_loss`` equals JAX's within 1e-6 (a class absent from both the
    predictions and the targets is left out of the mean)."""
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(2, 6, 6, 5)).astype(np.float32)
    labels = rng.integers(0, 4, size=(2, 6, 6))
    for ncls in (5, 7):
        np.testing.assert_allclose(
            float(loss_lib.dice_loss(torch.from_numpy(logits), torch.from_numpy(labels), ncls)),
            float(jloss.dice_loss(jnp.asarray(logits), jnp.asarray(labels), ncls)), rtol=1e-6)


# ---------------------------------------------------------------------------
# run_finetune: the probe -> unfreeze trajectory
# ---------------------------------------------------------------------------
N_TRAIN, BATCH, EPOCHS, UNFREEZE = 16, 8, 3, 1


@pytest.fixture(scope="module")
def seg_case(tmp_path_factory):
    """Synthetic 32-px m-cashew-plant (16 train, 8 val, 8 test) and a
    pretraining .pth of the small widths at patch 8 (GRN affines random)."""
    d = tmp_path_factory.mktemp("seg")
    gb.generate_synthetic_geobench(d, "m-cashew-plant", (N_TRAIN, 8, 8), seed=4, size=32)
    fc = FCMAE(img_size=56, patch_size=8, depths=DEPTHS, dims=DIMS, decoder_embed_dim=16,
               inp_modalities=JM.INP_MODALITIES, out_modalities=JM.OUT_MODALITIES)
    fc.init_weights(torch.Generator().manual_seed(6))
    with torch.no_grad():
        for name, p in fc.named_parameters():
            if ".grn." in name:
                p.copy_(0.5 * torch.randn(p.shape, generator=torch.Generator().manual_seed(7)))
    torch.save({"model": fc.state_dict()}, d / "pt.pth")
    return d


def _cfg(d, unfreeze_epoch=UNFREEZE, epochs=EPOCHS, batch_size=BATCH):
    return FinetuneConfig(
        model=ModelConfig(model="convnextv2_unet_atto", img_size=32, patch_size=8),
        optim=OptimConfig(blr=4e-2, min_lr=1e-6, weight_decay=0.3, warmup_epochs=1,
                          betas=(0.9, 0.999), layer_decay=0.9),
        run=RunConfig(epochs=epochs, seed=0, use_bf16=False, loss_aggr="unweighted"),
        data_set="m-cashew-plant", processed_dir=str(d), finetune=str(d / "pt.pth"),
        linear_probe=True, smoothing=0.0, drop_path=0.0, batch_size=batch_size,
        unfreeze_epoch=unfreeze_epoch)


@pytest.fixture()
def small_unet(monkeypatch):
    """``convnextv2_unet_atto`` at the small widths in both packages, and the
    port's U-Net initialised with the JAX run's own init (JAX
    ``run_finetune`` draws its params from ``PRNGKey(seed)``), so the two
    runs start from the same weights."""
    for mod in (jft, tft):
        monkeypatch.setattr(mod, "model_size", lambda name: (DEPTHS, DIMS))
    build = tft.build_finetune_model

    def build_like_jax(cfg, in_channels, nb_classes):
        model = build(cfg, in_channels, nb_classes)
        jm = jft.build_finetune_model(jft_cfg(cfg), in_channels, nb_classes)
        params = jax.jit(jm.init)(jax.random.PRNGKey(cfg.run.seed),
                                  jnp.zeros((2, 32, 32, in_channels)))["params"]
        model.load_state_dict(from_jax_unet(np_tree(params), DEPTHS), strict=True)
        return model

    monkeypatch.setattr(tft, "build_finetune_model", build_like_jax)


def jft_cfg(cfg):
    """The JAX package's FinetuneConfig of the port's ``cfg``, at one sample a
    device of the 8-device CPU mesh (its batch counts every device)."""
    from mmearth_tpu.configs import config as jcfg

    return jcfg.FinetuneConfig(
        model=jcfg.ModelConfig(model=cfg.model.model, img_size=cfg.model.img_size,
                               patch_size=cfg.model.patch_size),
        optim=jcfg.OptimConfig(**{f: getattr(cfg.optim, f) for f in (
            "blr", "min_lr", "weight_decay", "warmup_epochs", "betas", "layer_decay")}),
        run=jcfg.RunConfig(epochs=cfg.run.epochs, seed=cfg.run.seed, use_bf16=False,
                           loss_aggr="unweighted"),
        data_set=cfg.data_set, processed_dir=cfg.processed_dir, finetune=cfg.finetune,
        linear_probe=True, smoothing=0.0, drop_path=0.0,
        batch_size=cfg.batch_size // jax.device_count(), unfreeze_epoch=cfg.unfreeze_epoch)


def test_probe_unfreeze_trajectory_matches_jax(seg_case, small_unet):
    """Three epochs of ``run_finetune`` on segmentation, the probe unfrozen
    at epoch 1, against JAX's ``run_finetune`` on the same packed data (the
    loaders yield the same batches) from the same weights: each epoch's loss
    within 1e-4 relative, the final params within 2e-5 absolute + 1e-4
    relative.  The unfreeze builds a fresh AdamW over every param but the
    unused final norm: its count restarts (JAX's fresh optax state and
    TrainState), so the schedule runs again from update 0, and the lr of
    each epoch's last update is the schedule's at the updates since the
    unfreeze."""
    cfg = _cfg(seg_case)
    ref = jft.run_finetune(jft_cfg(cfg))
    out = tft.run_finetune(cfg, device="cpu")
    per_epoch = N_TRAIN // BATCH
    assert [e["steps"] for e in out["history"]] == [per_epoch] * EPOCHS
    for ours, theirs in zip(out["history"], ref["history"]):
        np.testing.assert_allclose(ours["loss"], theirs["loss"], rtol=1e-4)
        assert 0.0 <= ours["val_Jaccard"] <= 1.0
    opt = out["optimizer"]
    names = [n for n, _ in out["model"].named_parameters()]
    assert opt.names == [n for n in names if not n.startswith("norm.")]
    assert opt.count == int(ref["state"].step) == (EPOCHS - UNFREEZE) * per_epoch
    sched = warmup_cosine(cfg.optim.absolute_lr(BATCH), cfg.optim.min_lr, EPOCHS,
                          cfg.optim.warmup_epochs, per_epoch)
    assert [e["lr"] for e in out["history"]] == [sched(per_epoch), sched(per_epoch),
                                                sched(2 * per_epoch)]
    want = from_jax_unet(np_tree(ref["state"].params), DEPTHS)
    for k, v in out["model"].state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].reshape(v.shape).numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
    assert math.isfinite(out["test_Jaccard"]) and 0.0 <= out["test_Jaccard"] <= 1.0


def test_probe_trains_the_decoder_alone_before_the_unfreeze(seg_case, small_unet):
    """One probe epoch (the unfreeze not reached): the optimizer holds the
    decoder and the head alone, and the bootstrapped encoder is unchanged."""
    out = tft.run_finetune(_cfg(seg_case, epochs=1), device="cpu")
    model, opt = out["model"], out["optimizer"]
    assert opt.names and all(lp.unet_probe_trainable(n) for n in opt.names)
    assert {n for n, p in model.named_parameters() if p.requires_grad} == set(opt.names)
    enc = lp.encoder_state_from_checkpoint(seg_case / "pt.pth", DEPTHS)
    sd = model.state_dict()
    assert enc and all(torch.equal(sd[k], v) for k, v in enc.items())


def test_unet_without_probe_raises(seg_case, small_unet):
    cfg = _cfg(seg_case)
    with pytest.raises(ValueError, match="linear_probe"):
        tft.run_finetune(FinetuneConfig(**{**cfg.__dict__, "linear_probe": False}), device="cpu")


def test_staged_resume_continues_the_unfrozen_run(seg_case, small_unet, tmp_path):
    """A staged run stopped after epoch 1 (the first after the unfreeze)
    and resumed ends where an uninterrupted run ends, bit for bit: the
    checkpoint's optimizer is the unfrozen model's, and the resume restores
    it into one (where JAX's run would unfreeze anew)."""
    base = _cfg(seg_case)
    run = RunConfig(epochs=EPOCHS, seed=0, use_bf16=False, loss_aggr="unweighted",
                    output_dir=str(tmp_path / "out"))
    whole = tft.run_finetune(base, device="cpu")
    tft.run_finetune(FinetuneConfig(**{**base.__dict__, "run": RunConfig(
        **{**run.__dict__, "epochs": 2})}), device="cpu")
    resumed = tft.run_finetune(FinetuneConfig(**{**base.__dict__, "run": run}), device="cpu")
    assert [e["epoch"] for e in resumed["history"]] == [2]
    assert resumed["optimizer"].count == (EPOCHS - UNFREEZE) * (N_TRAIN // BATCH)
    for k, v in resumed["model"].state_dict().items():
        assert torch.equal(v, whole["model"].state_dict()[k]), k


def test_synthetic_cashew_matches_jax(tmp_path):
    """The port's synthetic m-cashew-plant (masks (N, H, W)) holds the JAX
    package's arrays at its default 64 px."""
    ours = gb.generate_synthetic_geobench(tmp_path / "t", "m-cashew-plant", (3, 2, 2), seed=5)
    ref = jgb.generate_synthetic_geobench(tmp_path / "j", "m-cashew-plant", (3, 2, 2), seed=5)
    for split in ("train", "val", "test"):
        for field in ("input", "label"):
            np.testing.assert_array_equal(np.load(ours[split] / f"{field}.bin"),
                                          np.load(ref[split] / f"{field}.bin"))

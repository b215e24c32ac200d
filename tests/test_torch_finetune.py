"""The port's GEO-Bench finetune slice against the JAX package on the CPU:
the dense classifier (both padding modes), the losses, the metrics, the
finetune weight-decay mask and layer-decay scales, a 3-update f32 finetune
trajectory and a head-only probe, the ``.pth`` bootstrap, and
``mmearth_tpu_torch.main_finetune`` end to end (classification, the U-Net
and the ResNet baselines) with its refusals.  Small
widths, seeded numpy inputs, f32; each tolerance is stated where it is used.
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
from mmearth_tpu.eval import metrics as jmet
from mmearth_tpu.losses import finetune as jloss
from mmearth_tpu.models import convnextv2 as jcnx
from mmearth_tpu.train import optim as joptim
from mmearth_tpu.train import ema as jema
from mmearth_tpu.train.finetune import make_finetune_step
from mmearth_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
from mmearth_tpu.train.step import TrainState
from mmearth_tpu_torch import main_finetune
from mmearth_tpu_torch.checkpoints import load_pretrained as lp
from mmearth_tpu_torch.checkpoints.convert import from_jax_classifier
from mmearth_tpu_torch.data import geobench as gb
from mmearth_tpu_torch.eval import metrics as met
from mmearth_tpu_torch.losses import finetune as loss_lib
from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
from mmearth_tpu_torch.models.fcmae import FCMAE
from mmearth_tpu_torch.ops import dwconv, fused_block, patch_select, wholeblock
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train.ema import init_ema, update_ema
from mmearth_tpu_torch.train.finetune import finetune_step
from mmearth_tpu_torch.train.schedule import warmup_cosine

from _torch_parity import assert_grads_close, np_tree, randomize_grn
from test_baselines import fake_torch_resnet_sd

DEPTHS, DIMS, NCLS = (1, 1, 2, 1), (8, 16, 24, 32), 10
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and torch's
    CPU thread pools, one per core in every worker, would contend for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _classifier(padding_mode="same", patch_size=8, seed=0, use_orig_stem=False,
                head_init_scale=0.5):
    """The port's classifier and the same weights as a JAX param tree (GRN
    affines randomized: they init to zero, which hides GRN bugs)."""
    kw = dict(patch_size=patch_size, img_size=56, in_chans=12, depths=DEPTHS, dims=DIMS,
              use_orig_stem=use_orig_stem)
    tm = ConvNeXtV2(**kw, sparse=False, num_classes=NCLS, head_init_scale=head_init_scale,
                    padding_mode=padding_mode)
    tm.init_weights(torch.Generator().manual_seed(seed))
    # copies: a JAX array made from a numpy view may alias the torch param's
    # memory, which the port's optimizer later updates in place
    sd = {k: v.numpy().copy() for k, v in tm.state_dict().items()}
    params = randomize_grn(jax.tree_util.tree_map(
        jnp.asarray, jtc.torch_encoder_to_flax(sd, DEPTHS, use_orig_stem, include_head=True)),
        seed)
    tm.load_state_dict(from_jax_classifier(np_tree(params), DEPTHS), strict=True)
    jm = jcnx.ConvNeXtV2(**kw, num_classes=NCLS, sparse=False, padding_mode=padding_mode)
    return tm, jm, params


def _close(got, ref, what, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=rtol * max(float(np.abs(ref).max()), 1e-6), err_msg=what)


@pytest.mark.parametrize("padding_mode,patch_size,size", [("same", 8, 64), ("reference", 8, 64),
                                                          ("reference", 16, 48)])
def test_classifier_matches_jax(padding_mode, patch_size, size):
    """Logits and every param grad of ``ConvNeXtV2(sparse=False)`` against
    JAX ``model.apply`` (drop path 0), within 1e-4 of the scale (f32 sums in
    another order).  ``reference`` runs the initial conv VALID (64 -> 62 ->
    31 -> 15 -> 7 at stride 1) and pads the stride-2 stem by 1."""
    n = 3
    rng = np.random.default_rng(size + patch_size)
    x = rng.normal(size=(n, size, size, 12)).astype(np.float32)
    r = rng.normal(size=(n, NCLS)).astype(np.float32)
    tm, jm, params = _classifier(padding_mode, patch_size)

    @jax.jit
    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(logits * r), logits

    (_, ref), g_ref = jax.value_and_grad(loss, has_aux=True)(params)
    logits = tm(torch.from_numpy(x))
    (logits * torch.from_numpy(r)).sum().backward()
    _close(logits.detach().numpy(), ref, "logits")
    assert_grads_close(tm, from_jax_classifier(np_tree(g_ref), DEPTHS), RTOL)


@pytest.mark.parametrize("patch_size,size", [(8, 64), (16, 48)])
def test_orig_stem_classifier_matches_jax(patch_size, size):
    """The classifier with the original stem (s = 1 at patch 8, 2 at patch
    16): logits and every param grad against JAX, as above."""
    n = 2
    rng = np.random.default_rng(size)
    x = rng.normal(size=(n, size, size, 12)).astype(np.float32)
    r = rng.normal(size=(n, NCLS)).astype(np.float32)
    tm, jm, params = _classifier(patch_size=patch_size, use_orig_stem=True)
    assert tm.stem_orig[0].weight.shape[-1] == patch_size // 8

    @jax.jit
    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(x))
        return jnp.sum(logits * r), logits

    (_, ref), g_ref = jax.value_and_grad(loss, has_aux=True)(params)
    logits = tm(torch.from_numpy(x))
    (logits * torch.from_numpy(r)).sum().backward()
    _close(logits.detach().numpy(), ref, "logits")
    assert_grads_close(tm, from_jax_classifier(np_tree(g_ref), DEPTHS), RTOL)


def test_classifier_refusals():
    with pytest.raises(ValueError, match="dense-only"):
        ConvNeXtV2(padding_mode="reference")


def test_losses_match_jax():
    """Smoothed CE, smoothed BCE and the segmentation CE, and the criterion
    each dataset picks, within 1e-6 relative (f32 log-softmax)."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.normal(size=(6, NCLS))).astype(np.float32)
    labels = rng.integers(0, NCLS, size=(6,))
    multi = (rng.random((6, NCLS)) < 0.3).astype(np.int64)
    seg_logits = rng.normal(size=(2, 5, 5, 7)).astype(np.float32)
    seg_labels = rng.integers(0, 7, size=(2, 5, 5))
    t = lambda a: torch.from_numpy(np.asarray(a))
    j = jnp.asarray
    for s in (0.0, 0.2):
        _close(loss_lib.smoothed_cross_entropy(t(logits), t(labels), s),
               jloss.smoothed_cross_entropy(j(logits), j(labels), s), "ce", 1e-6)
        _close(loss_lib.smoothed_binary_cross_entropy(t(logits), t(multi), s),
               jloss.smoothed_binary_cross_entropy(j(logits), j(multi), s), "bce", 1e-6)
    _close(loss_lib.segmentation_cross_entropy(t(seg_logits), t(seg_labels)),
           jloss.segmentation_cross_entropy(j(seg_logits), j(seg_labels)), "seg", 1e-6)
    for ds, (lg, lb) in (("m-eurosat", (logits, labels)), ("m-bigearthnet", (logits, multi)),
                         ("m-cashew-plant", (seg_logits, seg_labels))):
        _close(loss_lib.criterion_fn(ds, 0.2)(t(lg), t(lb)),
               jloss.criterion_fn(ds, 0.2)(j(lg), j(lb)), ds, 1e-6)


@pytest.mark.parametrize("dataset", ["m-eurosat", "m-bigearthnet", "m-SA-crop-type"])
def test_metrics_match_jax(dataset):
    """Accuracy, micro F1 and macro Jaccard from batch statistics summed over
    three batches, and from the host ``update`` path: equal to JAX's."""
    rng = np.random.default_rng(1)
    ncls = gb.NUM_CLASSES[dataset]
    batches = []
    for _ in range(3):
        if dataset == "m-bigearthnet":
            lab = (rng.random((5, ncls)) < 0.3).astype(np.int64)
            lg = rng.normal(size=(5, ncls)).astype(np.float32)
        elif dataset == "m-SA-crop-type":
            lab = rng.integers(-1, ncls, size=(2, 4, 4))
            lg = rng.normal(size=(2, 4, 4, ncls)).astype(np.float32)
        else:
            lab = rng.integers(0, ncls, size=(5,))
            lg = rng.normal(size=(5, ncls)).astype(np.float32)
        batches.append((lg, lab))
    name, ours = met.metric_for(dataset, ncls)
    jname, ref = jmet.metric_for(dataset, ncls)
    assert name == jname
    stats_fn = met.batch_stats_fn(dataset, ncls)
    jstats_fn = jmet.batch_stats_fn(dataset, ncls)
    sums = {}
    for lg, lab in batches:
        for k, v in stats_fn(torch.from_numpy(lg), torch.from_numpy(lab)).items():
            sums[k] = sums[k] + v if k in sums else v
        ref.update_stats(jax.tree_util.tree_map(np.asarray, jstats_fn(jnp.asarray(lg),
                                                                      jnp.asarray(lab))))
    ours.update_stats({k: v.numpy() for k, v in sums.items()})
    assert ours.compute() == ref.compute()
    ours.reset()
    ref.reset()
    for lg, lab in batches:
        ours.update(lg, lab)
        ref.update(lg, lab)
    assert ours.compute() == ref.compute()


def _leafwise(tree_fn, params):
    """A JAX per-leaf decision as the port's state dict (each leaf's value
    broadcast to the leaf's shape, carried by the converter)."""
    return from_jax_classifier(jax.tree_util.tree_map(
        lambda m, p: np.full(np.shape(p), float(m), np.float32), tree_fn(params), params), DEPTHS)


@pytest.mark.parametrize("kind", ["single", "group"])
def test_wd_mask_and_layer_scales_match_jax(kind):
    """Per param: the finetune decay mask and the layer-decay lr scale
    (decay 0.9) equal JAX's; the stem takes the top layer id, as the head."""
    tm, _, params = _classifier()
    named = list(tm.named_parameters())
    ref_mask = _leafwise(joptim.finetune_wd_mask, params)
    ours = toptim.finetune_wd_mask(named)
    assert ours == {k: bool(ref_mask[k].reshape(-1)[0]) for k in ours}
    assert not ours["stages.0.0.grn.gamma"] and ours["stages.0.0.dwconv.weight"]
    ref_scale = _leafwise(lambda p: joptim.layer_lr_scales(p, 0.9, DEPTHS, kind), params)
    scales = toptim.layer_lr_scales(named, 0.9, DEPTHS, kind)
    for k, v in scales.items():
        np.testing.assert_allclose(v, float(ref_scale[k].reshape(-1)[0]), rtol=1e-6, err_msg=k)
    assert scales["initial_conv.0.weight"] == scales["head.weight"] == 1.0


@pytest.mark.parametrize("mode,kind", [("finetune", "single"), ("finetune", "group"),
                                       ("probe", "single")])
def test_three_update_trajectory_matches_jax(mode, kind):
    """3 f32 updates of the classifier (drop path 0, smoothing 0.2, layer
    decay 0.9, wd 0.3, AdamW (0.9, 0.999)) against JAX's
    ``make_finetune_optimizer`` + ``make_finetune_step``.  Params within 2e-5
    absolute + 1e-4 relative: Adam's first updates move each param by ~lr
    whatever |g|, so a grad difference of ~1e-5 of its scale moves a param
    by at most ~lr * 1e-2.  The probe trains the head alone: every other
    param stays bit-identical."""
    n = 4
    rng = np.random.default_rng(7)
    batches = [{"input": rng.normal(size=(n, 64, 64, 12)).astype(np.float32),
                "label": rng.integers(0, NCLS, size=(n,)).astype(np.int32)} for _ in range(3)]
    tm, jm, params = _classifier(seed=3)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    sched_args = (1e-2, 1e-6, 4, 1, 2)
    trainable = jlp.classifier_probe_trainable if mode == "probe" else jlp.all_trainable
    tx = joptim.make_finetune_optimizer(
        params, jax_warmup_cosine(*sched_args), 0.3, (0.9, 0.999), 0.9, kind, DEPTHS,
        trainable_mask=joptim.zero_grads_mask(params, trainable))
    state = TrainState.create(params, tx)
    step_fn = jax.jit(make_finetune_step(jm, jloss.criterion_fn("m-eurosat", 0.2), False))
    for b in batches:
        state, _ = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))

    for name, prm in tm.named_parameters():
        prm.requires_grad_(mode == "finetune" or name.startswith("head"))
    named = [(k, p) for k, p in tm.named_parameters() if p.requires_grad]
    opt = toptim.AdamW(named, warmup_cosine(*sched_args), 0.3, (0.9, 0.999),
                       wd_mask=toptim.finetune_wd_mask(named),
                       lr_scales=toptim.layer_lr_scales(named, 0.9, DEPTHS, kind))
    gen = torch.Generator().manual_seed(0)
    for b in batches:
        loss = finetune_step(tm, opt, {k: torch.from_numpy(v) for k, v in b.items()},
                             loss_lib.criterion_fn("m-eurosat", 0.2), gen)
        assert math.isfinite(float(loss))
    assert opt.count == 3
    ref = from_jax_classifier(np_tree(state.params), DEPTHS)
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].reshape(v.shape).numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
        if mode == "probe" and not k.startswith("head"):
            assert torch.equal(v, init[k]), k
    assert float((tm.head.weight.detach() - init["head.weight"]).abs().max()) > 1e-4


def test_ema_matches_jax_and_waits_for_applied_updates():
    """``update_ema`` equals JAX's on the same params within 1e-6 relative
    (an f32 multiply-add rounded in another order);
    in ``finetune_step`` with ``update_freq = 2`` the EMA holds still on the
    accumulation-only micro-step (decay 1.0) and moves on the applied one."""
    tm, _, params = _classifier(seed=4)
    ema = init_ema(tm)
    ref = jema.update_ema(jema.init_ema(params), jax.tree_util.tree_map(lambda a: a * 1.5, params),
                          0.9)
    with torch.no_grad():
        for p in tm.parameters():
            p.mul_(1.5)
    update_ema(ema, tm, 0.9)
    ref_sd = from_jax_classifier(np_tree(ref), DEPTHS)
    for k, v in ema.items():
        np.testing.assert_allclose(v.numpy(), ref_sd[k].reshape(v.shape).numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=k)

    named = list(tm.named_parameters())
    opt = toptim.AdamW(named, lambda step: 1e-2, 0.0, update_freq=2)
    ema = init_ema(tm)
    start = {k: v.clone() for k, v in ema.items()}
    rng = np.random.default_rng(0)
    batch = {"input": torch.from_numpy(rng.normal(size=(2, 32, 32, 12)).astype(np.float32)),
             "label": torch.tensor([1, 2])}
    crit, gen = loss_lib.criterion_fn("m-eurosat", 0.0), torch.Generator().manual_seed(0)
    finetune_step(tm, opt, batch, crit, gen, ema=ema, ema_decay=0.5)
    assert all(torch.equal(ema[k], start[k]) for k in ema)  # accumulation only
    finetune_step(tm, opt, batch, crit, gen, ema=ema, ema_decay=0.5)
    for k, p in tm.named_parameters():
        torch.testing.assert_close(ema[k], 0.5 * start[k] + 0.5 * p.detach(), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("source", ["port_fcmae", "jax_finetune_export"])
def test_pth_bootstrap_matches_jax(source, tmp_path):
    """``encoder_state_from_checkpoint`` -> ``load_encoder_into`` ->
    ``reinit_head`` against JAX's ``encoder_tree_from_checkpoint`` ->
    ``load_encoder_into`` -> ``reinit_head`` on the same ``.pth``: the port's
    FCMAE state dict (dense GRN (1, 1, 1, C)), and the JAX package's
    ``flax_fcmae_to_torch(target="finetune")`` export (GRN (1, C)).  Every
    value bit-identical, the head redrawn at std 2e-5 with a zero bias."""
    kw = dict(img_size=56, patch_size=8, depths=DEPTHS, dims=DIMS, decoder_embed_dim=16,
              inp_modalities=JM.INP_MODALITIES, out_modalities=JM.OUT_MODALITIES)
    fc = FCMAE(**kw).init_weights(torch.Generator().manual_seed(5))
    path = tmp_path / "pt.pth"
    if source == "port_fcmae":
        torch.save({"model": fc.state_dict()}, path)
    else:
        tree = jtc.torch_fcmae_to_flax({k: v.numpy() for k, v in fc.state_dict().items()},
                                       DEPTHS, JM.OUT_MODALITIES)
        jtc.save_pth(path, jtc.flax_fcmae_to_torch(tree, DEPTHS, JM.OUT_MODALITIES))
    tm, _, params = _classifier(seed=9)
    enc = jlp.encoder_tree_from_checkpoint(path, DEPTHS)
    ref = from_jax_classifier(np_tree(jlp.reinit_head(jlp.load_encoder_into(params, enc), 4)),
                              DEPTHS)
    state = lp.reinit_head(lp.load_encoder_into(
        tm.state_dict(), lp.encoder_state_from_checkpoint(path, DEPTHS)), 4)
    assert set(state) == set(ref)
    for k, v in state.items():
        assert torch.equal(v, ref[k].reshape(v.shape)), k
    assert torch.equal(state["stages.0.0.dwconv.weight"],
                       fc.state_dict()["encoder.stages.0.0.dwconv.weight"])
    assert not state["head.bias"].any() and float(state["head.weight"].std()) < 1e-4


def test_minkowski_remap_matches_jax():
    """The copy of ``remap_minkowski_keys`` on a raw Minkowski-layout encoder
    (conv and depthwise ``kernel``s, ``ln``/``linear`` segments, (1, C)
    biases and GRN affines) gives JAX's keys and arrays."""
    rng = np.random.default_rng(2)
    raw = {
        "encoder.stem.0.kernel": rng.normal(size=(1, 8)),
        "encoder.stem.0.bias": rng.normal(size=(1, 8)),
        "encoder.downsample_layers.0.1.kernel": rng.normal(size=(4, 8, 16)),
        "encoder.stages.0.0.dwconv.kernel": rng.normal(size=(49, 8)),
        "encoder.stages.0.0.norm.ln.weight": rng.normal(size=(8,)),
        "encoder.stages.0.0.pwconv1.linear.weight": rng.normal(size=(32, 8)),
        "encoder.stages.0.0.grn.gamma": rng.normal(size=(1, 32)),
    }
    ours, ref = lp.remap_minkowski_keys(raw), jtc.remap_minkowski_keys(raw)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# main_finetune end to end on the CPU
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def geobench_dir(tmp_path_factory):
    """Synthetic packed m-eurosat, m-bigearthnet and m-cashew-plant (12
    train, 4 val, 4 test), a pretraining .pth of convnextv2_atto, and two
    foreign ResNet-18 .pth files of random 12-band weights: SeCo's (MoCo
    ``encoder_q.`` keys) and Satlas's (foreign names), renamed by position
    when loaded."""
    d = tmp_path_factory.mktemp("geobench")
    for ds in ("m-eurosat", "m-bigearthnet", "m-cashew-plant"):
        gb.generate_synthetic_geobench(d, ds, (12, 4, 4))
    fc = FCMAE(img_size=56, patch_size=8, depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
    torch.save({"model": fc.init_weights(torch.Generator().manual_seed(0)).state_dict()},
               d / "pt.pth")
    backbone = {k: torch.from_numpy(v) for k, v in fake_torch_resnet_sd(
        (2, 2, 2, 2), False, in_ch=12, seed=2).items() if not k.startswith("fc.")}
    torch.save({"state_dict": {f"encoder_q.{k}": v for k, v in backbone.items()}},
               d / "seco_r18.pth")
    torch.save({f"backbone.{i}": v for i, v in enumerate(backbone.values())},
               d / "satlas_r18.pth")
    torch.save(backbone, d / "backbone_r18.pth")
    return d


def test_synthetic_geobench_matches_jax(tmp_path):
    """The port's synthetic GEO-Bench pack holds the JAX package's arrays."""
    ours = gb.generate_synthetic_geobench(tmp_path / "t", "m-bigearthnet", (4, 2, 2), seed=3)
    ref = jgb.generate_synthetic_geobench(tmp_path / "j", "m-bigearthnet", (4, 2, 2), seed=3)
    for split in ("train", "val", "test"):
        for field in ("input", "label", "mean", "std"):
            a = np.load(ours[split] / f"{field}.bin")
            np.testing.assert_array_equal(a, np.load(ref[split] / f"{field}.bin"))


def _args(d, *extra):
    return main_finetune.get_args_parser().parse_args([
        "--device", "cpu", "--model", "convnextv2_atto", "--input_size", "56",
        "--patch_size", "8", "--processed_dir", str(d), "--finetune", str(d / "pt.pth"),
        "--batch_size", "4", "--epochs", "1", "--blr", "2e-4", "--layer_decay", "0.9",
        "--weight_decay", "0.3", "--drop_path", "0.1", "--smoothing", "0.2", *extra])


def _launches():
    return {**patch_select.LAUNCHES, **wholeblock.LAUNCHES, **fused_block.LAUNCHES,
            **dwconv.LAUNCHES}


@pytest.mark.parametrize("data_set,metric,probe", [("m-eurosat", "Accuracy", False),
                                                   ("m-eurosat", "Accuracy", True),
                                                   ("m-bigearthnet", "F1Score", False)])
def test_main_finetune_runs_on_cpu(geobench_dir, data_set, metric, probe):
    """The recipe on the CPU in bf16 (the kernels' plain versions): 3 steps
    of batch 4, finite losses, val and test scores in [0, 1], no kernel
    launched; the probe leaves every trunk param as bootstrapped."""
    before = _launches()
    out = main_finetune.main(_args(geobench_dir, "--data_set", data_set,
                                   "--linear_probe", str(probe)))
    (epoch,) = out["history"]
    assert epoch["steps"] == 3 and all(math.isfinite(v) for v in epoch["step_losses"])
    assert 0.0 <= epoch[f"val_{metric}"] <= 1.0 and 0.0 <= out[f"test_{metric}"] <= 1.0
    assert _launches() == before
    model = out["model"]
    assert model.head.out_features == gb.NUM_CLASSES[data_set]
    if probe:
        enc = lp.encoder_state_from_checkpoint(geobench_dir / "pt.pth", model.depths)
        sd = model.state_dict()
        assert all(torch.equal(sd[k], v) for k, v in enc.items())
        assert [n for n, p in model.named_parameters() if p.requires_grad] == ["head.weight",
                                                                              "head.bias"]


@pytest.mark.parametrize("model,data_set,checkpoint,metric", [
    ("convnextv2_unet_atto", "m-cashew-plant", "pt.pth", "Jaccard"),
    ("resnet18", "m-eurosat", "seco_r18.pth", "Accuracy"),
    ("resnet18_unet", "m-cashew-plant", "satlas_r18.pth", "Jaccard"),
])
def test_main_finetune_runs_seg_and_baselines_on_cpu(geobench_dir, model, data_set, checkpoint,
                                                     metric):
    """Segmentation and the baselines through the CLI on the CPU in bf16, 2
    epochs of 3 steps at batch 4: the atto U-Net and the ResNet-18 U-Net as
    the probe (its encoder, bootstrapped, stays as the checkpoint holds it),
    the ResNet-18 classifier finetuned from a SeCo file (its backbone
    bootstrapped, then trained).  Finite losses, val and test scores in
    [0, 1], no kernel launched."""
    before = _launches()
    seg = data_set == "m-cashew-plant"
    out = main_finetune.main(_args(geobench_dir, "--model", model, "--data_set", data_set,
                                   "--finetune", str(geobench_dir / checkpoint), "--epochs", "2",
                                   "--linear_probe", str(seg)))
    history = out["history"]
    assert [e["steps"] for e in history] == [3, 3]
    assert all(math.isfinite(v) for e in history for v in e["step_losses"])
    assert all(0.0 <= e[f"val_{metric}"] <= 1.0 for e in history)
    assert 0.0 <= out[f"test_{metric}"] <= 1.0
    assert _launches() == before and all(not any(e["launches"].values()) for e in history)
    sd = out["model"].state_dict()
    if model == "convnextv2_unet_atto":
        enc = lp.encoder_state_from_checkpoint(geobench_dir / "pt.pth", (2, 2, 6, 2))
        assert all(torch.equal(sd[k], v) for k, v in enc.items())
        assert sd["head.weight"].shape == (gb.NUM_CLASSES[data_set], 20, 1, 1)
    else:
        conv1 = torch.load(geobench_dir / "backbone_r18.pth")["conv1.weight"]
        got = sd["encoder.conv1.weight" if seg else "conv1.weight"]
        assert torch.equal(got, conv1) == seg  # frozen under the probe, trained otherwise
        assert (got - conv1).abs().max() < 1e-2


@pytest.mark.parametrize("extra,error,match", [
    (["--opt", "adamp"], ValueError, "adamp")])
def test_not_ported_options_raise(geobench_dir, extra, error, match):
    """What the port refuses: the --opt names JAX's optax build refuses too
    (``--wandb`` and ``--distributed`` run as JAX's do:
    ``tests/test_torch_tools.py``)."""
    with pytest.raises(error, match=match):
        main_finetune.main(_args(geobench_dir, *extra))


def test_cuda_without_a_card_raises(geobench_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _args(geobench_dir)
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_finetune.main(args)

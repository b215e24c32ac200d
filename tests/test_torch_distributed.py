"""The port's data parallelism (``mmearth_tpu_torch/parallel/mesh.py``) at world
size 2 on the CPU: two gloo ranks, spawned once for the module
(``tests/_torch_dist_worker.py``), each on its rows of a rank-major global
batch, against JAX's step on the same global batch sharded over a 2-device
``data`` mesh of the 8-device simulation (``tests/conftest.py``), and
against the port's own one-process step on the concatenated batch.

Tolerances, as ``tests/test_torch_model.py`` holds an f32 step: the loss
and per-modality losses within 1e-4 of their scale, every gradient within
1e-3 of its tensor's largest magnitude (atol = rtol * max|ref|).  Both
sides compute the same f32 math; the sums (GRN statistics over two ranks,
convs, matmuls) run in other orders, and JAX's FCMAE with an explicit mask
takes its masked-dense encoder, whose GRN sums also include the zeros of
the masked sites.  The ResNet-18 runs in f64 on both sides (1e-6; flax's
BatchNorm variance cancels in f32, ``tests/test_torch_resnet.py``).  Port
against port: losses within 1e-5; params after AdamW within 1e-4 of their
scale, as against JAX (Adam divides by the gradient's own magnitude, so
where a gradient is near 0 its summation-order noise moves the update more
than the gradient).
"""
import socket
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from mmearth_tpu.checkpoints.torch_convert import torch_fcmae_to_flax
from mmearth_tpu.configs import modalities as JM
from mmearth_tpu.losses import finetune as jloss
from mmearth_tpu.models import fcmae as jfc
from mmearth_tpu.models import resnet as jres
from mmearth_tpu.parallel import mesh as jmesh
from mmearth_tpu.train import optim as joptim
from mmearth_tpu_torch.checkpoints.convert import from_jax_fcmae, from_jax_resnet
from mmearth_tpu_torch.configs.config import FinetuneConfig, OptimConfig
from mmearth_tpu_torch.data import geobench as gb
from mmearth_tpu_torch.data.loader import PackedDataset, PackedLoader
from mmearth_tpu_torch.data.synthetic import generate, generate_packed, synthetic_batch
from mmearth_tpu_torch.eval.metrics import batch_stats_fn, metric_for
from mmearth_tpu_torch.losses.finetune import criterion_fn
from mmearth_tpu_torch.models import fcmae as tfc
from mmearth_tpu_torch.models.resnet import resnet_spec
from mmearth_tpu_torch.train import finetune as tft
from mmearth_tpu_torch.train.optim import AdamW
from mmearth_tpu_torch.train.step import draw, fold_in, pretrain_step

import _torch_dist_worker as worker
from _torch_parity import close, np_tree, random_mask

WORLD = 2
N = 4  # the global batch: 2 rows a rank
DEPTHS, DIMS = (1, 1, 1, 1), (8, 16, 32, 64)
KW = dict(img_size=56, patch_size=8, depths=DEPTHS, dims=DIMS, decoder_embed_dim=32)
RTOL, GRAD_RTOL, F64_RTOL, PORT_RTOL = 1e-4, 1e-3, 1e-6, 1e-5
LR, WD, BETAS = 1e-3, 0.05, (0.9, 0.95)
NCLS = 5
UNET_KW = dict(patch_size=8, img_size=32, in_chans=12, num_classes=4, depths=DEPTHS,
               dims=DIMS, drop_path_rate=0.3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fcmae_inputs(rng):
    """The port's FCMAE weights (GRN affines and uncertainty weights made
    non-trivial), the batches and masks."""
    tm = tfc.FCMAE(**KW).init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():  # the decoder's params are shared by every modality's keys
        for name, p in tm.named_parameters():
            if ".grn." in name:
                p.copy_(torch.from_numpy(0.5 * rng.normal(size=p.shape).astype(np.float32)))
        tm.loss_fn.log_vars.copy_(torch.linspace(-0.5, 0.5, 12))
    sd = tm.state_dict()
    k = int(49 * (1 - 0.6))
    batch = synthetic_batch(N, 56, seed=3)
    nan_batch = {key: v.copy() for key, v in batch.items()}
    # rank 0's era5 targets mostly missing, rank 1's land cover mostly unlabelled
    nan_batch["era5"][:2, 1:] = np.nan
    nan_batch["dynamic_world"][2:, :40] = -1
    return dict(kw=KW, sd=sd, batch=batch, batch2=synthetic_batch(N, 56, seed=4),
                nan_batch=nan_batch, mask=random_mask(rng, N, 49, k),
                mask2=random_mask(rng, N, 49, k), raw64=synthetic_batch(N, 64, seed=5),
                lr=LR, wd=WD, betas=BETAS)


def _resnet_inputs(rng):
    jm = jres.resnet18(num_classes=NCLS, in_chans=3, dtype=jnp.float64)
    with jax.enable_x64(True):
        v = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 3)))
    params, stats = v["params"], v["batch_stats"]
    stage_sizes, bottleneck = resnet_spec("resnet18")
    sd = from_jax_resnet(np_tree(params), np_tree(stats), stage_sizes, bottleneck)
    return jm, params, stats, dict(
        ncls=NCLS, resnet_sd=sd, resnet_x=rng.normal(size=(N, 32, 32, 3)),
        resnet_y=rng.integers(0, NCLS, size=(N,)))


def _seg_cfg(batch_size):
    return FinetuneConfig(batch_size=batch_size, optim=OptimConfig(
        lr=1e-2, warmup_epochs=0, weight_decay=0.05, layer_decay=1.0, opt="momentum"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the two ranks once (they run while JAX computes the
    references here), then gather both ranks' results."""
    rng = np.random.default_rng(0)
    tmp = tmp_path_factory.mktemp("torch_dist")
    inp = _fcmae_inputs(rng)
    jm_res, res_params, res_stats, res_inp = _resnet_inputs(rng)
    inp.update(res_inp)
    seg = gb.generate_synthetic_geobench(tmp / "cashew", "m-cashew-plant", (4, 9, 2), size=32)
    inp.update(unet_kw=UNET_KW, seg_cfg=_seg_cfg(N // WORLD), seg_val=str(seg["val"]),
               seg_x=rng.normal(size=(N, 32, 32, 12)).astype(np.float32),
               seg_y=rng.integers(0, 4, size=(N, 32, 32)))
    generate_packed(tmp / "mmpack", n=11, tile=64, seed=0)
    generate(tmp / "h5", n=14, tile=64, seed=1)
    gb.generate_synthetic_geobench(tmp / "eurosat", "m-eurosat", (8, 4, 4))
    pt = tfc.FCMAE(img_size=56, patch_size=8, depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
    torch.save({"model": pt.init_weights(torch.Generator().manual_seed(0)).state_dict()},
               tmp / "pt.pth")
    inp.update(root=str(tmp), mmpack=str(tmp / "mmpack"), h5=str(tmp / "h5"),
               eurosat=str(tmp / "eurosat"), pt_pth=str(tmp / "pt.pth"))
    torch.save(inp, tmp / "inputs.pt")
    ctx = mp.spawn(worker.run, args=(WORLD, _free_port(), str(tmp)), nprocs=WORLD, join=False)
    try:
        refs = _jax_refs(inp, jm_res, res_params, res_stats)
        refs.update(_port_refs(inp))
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return inp, refs, ranks


def _sharded(tree, mesh):
    return jax.device_put(tree, jmesh.batch_sharding(mesh))


def _as_sd(tree):
    return from_jax_fcmae(np_tree(tree), DEPTHS, JM.OUT_MODALITIES)


def _jax_refs(inp, jm_res, res_params, res_stats) -> dict:
    """JAX's loss, per-modality losses, grads and AdamW-updated params of
    each FCMAE case on the global batch sharded over a 2-device mesh, the
    two-micro-step update, and the ResNet-18's f64 grads and statistics."""
    mesh = jmesh.create_mesh(WORLD, devices=jax.devices()[:WORLD])
    params = jax.tree_util.tree_map(jnp.asarray, torch_fcmae_to_flax(
        {k: v.numpy() for k, v in inp["sd"].items()}, DEPTHS, JM.OUT_MODALITIES))
    refs = {}
    grads_of = {}
    for scope in ("per_device", "global"):
        jm = jfc.FCMAE(**KW, grn_group=N // WORLD if scope == "per_device" else 0,
                       inp_modalities=JM.INP_MODALITIES, out_modalities=JM.OUT_MODALITIES)

        def loss_fn(p, b, m, jm=jm):
            out = jm.apply({"params": p}, b, mask=m)
            return out[0], out[3]

        grads_of[scope] = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    def grads(scope, which, mask="mask"):
        b = jfc.zero_nan_inputs({k: jnp.asarray(v) for k, v in inp[which].items()})
        return grads_of[scope](params, _sharded(b, mesh), _sharded(jnp.asarray(inp[mask]), mesh))

    def updated(update_freq):
        tx = joptim.make_pretrain_optimizer(params, lambda c: LR, WD, BETAS,
                                            update_freq=update_freq)

        def run(gs):
            state, p = tx.init(params), params
            for g in gs:
                upd, state = tx.update(g, state, p)
                p = optax.apply_updates(p, upd)
            return p

        return jax.jit(run)

    update = updated(1)
    for scope, _, _, which in worker.FCMAE_CASES:
        if (scope, which) in refs:
            continue
        (loss, ld), g = grads(scope, which)
        refs[(scope, which)] = {"loss": float(loss), "loss_dict": {k: float(v) for k, v in
                                                                   ld.items()},
                                "grads": _as_sd(g), "params": _as_sd(update([g]))}
    # both micro-steps take the grads at the same params: the first applies no update
    refs["update_freq_2"] = _as_sd(updated(2)([grads("per_device", which, m)[1] for which, m in
                                               (("batch", "mask"), ("batch2", "mask2"))]))
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa

        def res_loss(p, x, y):
            out, mutated = jm_res.apply({"params": p, "batch_stats": f64(res_stats)}, x,
                                        train=True, mutable=["batch_stats"])
            return jloss.smoothed_cross_entropy(out, y, 0.0), mutated["batch_stats"]

        (loss, stats), g = jax.jit(jax.value_and_grad(res_loss, has_aux=True))(
            f64(res_params), _sharded(jnp.asarray(inp["resnet_x"]), mesh),
            _sharded(jnp.asarray(inp["resnet_y"]), mesh))
        stage_sizes, bottleneck = resnet_spec("resnet18")
        refs["resnet"] = {"loss": float(loss), "sd": from_jax_resnet(
            jax.tree_util.tree_map(np.asarray, g),
            jax.tree_util.tree_map(np.asarray, stats), stage_sizes, bottleneck)}
    return refs


def _port_refs(inp) -> dict:
    """The port in one process on the concatenated batch: two drawn steps,
    a draw, the segmentation step and the val split's Jaccard."""
    raw = {k: torch.from_numpy(v) for k, v in inp["raw64"].items()}
    model = tfc.FCMAE(**KW, grn_group=N // WORLD, block_impl="wholeblock")
    model.load_state_dict(inp["sd"])
    opt = AdamW(model.named_parameters(), lambda c: LR, WD, BETAS)
    gen = torch.Generator().manual_seed(5)
    losses = [float(pretrain_step(model, opt, raw, i, gen)["loss"]) for i in range(2)]
    d = draw(model, raw["sentinel2"], 3, torch.Generator().manual_seed(5), crop=True)
    out = {"steps": {"losses": losses, "params": {k: p.detach().clone()
                                                  for k, p in model.named_parameters()}},
           "draw": {"tops": d.tops, "lefts": d.lefts, "noise": d.noise}}
    unet = worker._unet(inp)
    opt = tft.make_optimizer(_seg_cfg(N), unet, lambda name: True, 16)
    batch = {"input": torch.from_numpy(inp["seg_x"]), "label": torch.from_numpy(inp["seg_y"])}
    loss = tft.finetune_step(unet, opt, batch, criterion_fn("m-cashew-plant", 0.0),
                             fold_in(torch.Generator().manual_seed(3), 0))
    out["seg"] = {"loss": float(loss), "params": {k: p.detach().clone()
                                                  for k, p in unet.named_parameters()}}
    ncls = UNET_KW["num_classes"]
    _, metric = metric_for("m-cashew-plant", ncls)
    loader = PackedLoader(PackedDataset(inp["seg_val"]), 2, shuffle=False, drop_last=False)
    out["val_score"] = tft.evaluate(worker._unet(inp), loader,
                                    batch_stats_fn("m-cashew-plant", ncls), metric,
                                    torch.device("cpu"))
    return out


def _close_sd(got, ref, what, rtol):
    assert got, what
    for k, v in got.items():
        close(v.numpy(), ref[k].reshape(v.shape).numpy(), f"{what} {k}", rtol)


def _same_on_ranks(ranks, get):
    a, b = (get(r) for r in ranks)
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("case", [c for c in worker.FCMAE_CASES if c[3] == "batch"],
                         ids=lambda c: "-".join(c[:3]))
def test_pretrain_step_matches_jax_data_mesh(runs, case):
    """Under the per-device and the global GRN scope, on gathered
    ``wholeblock`` (the spill-g phases with their cross-rank sums), the
    composed tail (``auto``: MaskedGRN's autograd all-reduce) and
    masked-dense ``fused``: each rank's loss and per-modality losses are
    the global batch's, the gradients the optimizer applied are JAX's, and
    the update is the same on both ranks and equals optax's."""
    inp, refs, ranks = runs
    ref = refs[(case[0], case[3])]
    for r in ranks:
        got = r["fcmae"][case]
        close(got["loss"], ref["loss"], "loss", RTOL)
        for k, v in ref["loss_dict"].items():
            close(got["loss_dict"][k], v, f"loss {k}", RTOL)
        _close_sd(got["grads"], ref["grads"], "grad", GRAD_RTOL)
        _close_sd(got["params"], ref["params"], "updated param", RTOL)
    _same_on_ranks(ranks, lambda r: r["fcmae"][case]["params"])


def test_uneven_nan_targets_take_the_global_denominators(runs):
    """Rank 0's era5 targets and rank 1's land-cover labels mostly missing:
    the mean of the ranks' own losses (upstream DDP's report) is not the
    global batch's loss; the port's loss and gradients are JAX's."""
    inp, refs, ranks = runs
    case = ("per_device", "gathered", "wholeblock", "nan_batch")
    ref = refs[("per_device", "nan_batch")]
    naive = np.mean([r["fcmae"][case]["local_loss"] for r in ranks])
    assert abs(naive - ref["loss"]) > 10 * RTOL * abs(ref["loss"])
    for r in ranks:
        got = r["fcmae"][case]
        close(got["loss"], ref["loss"], "loss", RTOL)
        close(got["loss_dict"]["era5"], ref["loss_dict"]["era5"], "era5", RTOL)
        _close_sd(got["grads"], ref["grads"], "grad", GRAD_RTOL)


def test_update_freq_2_averages_then_reduces_once(runs):
    """Two micro-steps and one applied update (``update_freq`` 2): the
    params after it are optax's MultiSteps update of JAX's global grads."""
    inp, refs, ranks = runs
    for r in ranks:
        assert r["fcmae"]["update_freq_2"]["count"] == 1
        _close_sd(r["fcmae"]["update_freq_2"]["params"], refs["update_freq_2"],
                  "updated param", RTOL)
    _same_on_ranks(ranks, lambda r: r["fcmae"]["update_freq_2"]["params"])


def test_chained_step_at_world_size_2_equals_single_steps(runs):
    """Drawn crops and masks: a ``ChainedStep`` of two at W = 2 trains as two
    single steps do, which train as one process does on the concatenated
    batch (the same draws, the per-device GRN groups)."""
    inp, refs, ranks = runs
    for r in ranks:
        single, chained = r["chained"]["single"], r["chained"]["chained"]
        np.testing.assert_array_equal(chained["losses"], single["losses"])
        for k, v in single["params"].items():
            torch.testing.assert_close(chained["params"][k], v, rtol=0, atol=0, msg=k)
        close(np.array(single["losses"]), np.array(refs["steps"]["losses"]), "losses",
              PORT_RTOL)
        _close_sd(single["params"], refs["steps"]["params"], "param", RTOL)


def test_each_rank_draws_its_rows_of_the_global_draw(runs):
    """The crops and the mask noise of a step: rank r's are rows [2r, 2r + 2)
    of what one process draws for the global batch from the same seed."""
    inp, refs, ranks = runs
    for r, res in enumerate(ranks):
        for k, v in res["chained"]["draw"].items():
            torch.testing.assert_close(v, refs["draw"][k][2 * r:2 * r + 2], rtol=0, atol=0,
                                       msg=k)


def test_resnet18_train_step_takes_global_batch_statistics(runs):
    """A ResNet-18 classification step in train mode, in f64: the loss, the
    gradients and the BatchNorm running statistics are those of flax's
    BatchNorm over the global batch (JAX on the 2-device mesh)."""
    inp, refs, ranks = runs
    ref = refs["resnet"]
    for r in ranks:
        close(r["resnet"]["loss"], ref["loss"], "loss", F64_RTOL)
        _close_sd(r["resnet"]["grads"], ref["sd"], "grad", F64_RTOL)
        for k, v in r["resnet"]["buffers"].items():
            if k.endswith("num_batches_tracked"):
                assert int(v) == 1, k
            else:
                np.testing.assert_allclose(v.numpy(), ref["sd"][k].numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=k)
    _same_on_ranks(ranks, lambda r: r["resnet"]["buffers"])


def test_segmentation_step_equals_one_process(runs):
    """A U-Net step with drop path 0.3: the ranks' mean loss and the updated
    params equal one process's step on the concatenated batch (its drop
    path drawn for the global batch)."""
    inp, refs, ranks = runs
    for r in ranks:
        close(r["seg"]["loss"], refs["seg"]["loss"], "loss", PORT_RTOL)
        _close_sd(r["seg"]["params"], refs["seg"]["params"], "param", PORT_RTOL)
    _same_on_ranks(ranks, lambda r: r["seg"]["params"])


def test_evaluate_sums_the_ranks_statistics(runs):
    """9 val samples at batch 2: 3 batches on rank 0, 2 on rank 1; the
    Jaccard from the two shards equals one process's over the whole split."""
    inp, refs, ranks = runs
    assert [r["seg"]["val_batches"] for r in ranks] == [3, 2]
    for r in ranks:
        assert r["seg"]["val_score"] == refs["val_score"]


def test_pretrain_driver_shards_and_writes_on_rank_0(runs):
    """``main_pretrain`` at W = 2 (batch 2 a rank): the shards are disjoint and
    each step's pair of batches is the one-process epoch's batch of 4, both
    ranks report the same losses and end with the same params, and only
    rank 0 writes the checkpoint."""
    inp, refs, ranks = runs
    rows = [r["drivers"]["pretrain"]["epoch_rows"] for r in ranks]
    one = PackedLoader(PackedDataset(Path(inp["mmpack"]) / "train"), 4, seed=0)
    whole = one._epoch_batches()
    assert len(rows[0]) == len(rows[1]) == len(whole) == 2
    for i, batch in enumerate(whole):
        assert sorted(rows[0][i] + rows[1][i]) == sorted(batch.tolist())
        assert not set(rows[0][i]) & set(rows[1][i])
    h0, h1 = (r["drivers"]["pretrain"]["history"] for r in ranks)
    assert [e["steps"] for e in h0] == [2]
    assert h0[0]["step_losses"] == h1[0]["step_losses"] and h0[0]["loss"] == h1[0]["loss"]
    _same_on_ranks(ranks, lambda r: r["drivers"]["pretrain"]["params"])
    assert ranks[0]["drivers"]["pretrain"]["writes"] == ["checkpoint-0.pth"]
    assert ranks[1]["drivers"]["pretrain"]["writes"] == []


def test_grain_resume_restores_each_ranks_stream(runs):
    """``--loader grain`` at W = 2: two epochs in one run equal one epoch and
    a run resumed from its ``.pth``, which holds both ranks' stream
    positions; rank 0 alone writes."""
    inp, refs, ranks = runs
    for r in ranks:
        g = r["drivers"]["grain"]
        assert [e["epoch"] for e in g["rest"]["history"]] == [1]
        np.testing.assert_array_equal(
            [x for e in g["first"]["history"] + g["rest"]["history"] for x in e["step_losses"]],
            [x for e in g["whole"]["history"] for x in e["step_losses"]])
    ckpt = torch.load(Path(inp["root"]) / "grain_b" / "ckpt" / "checkpoint-1.pth",
                      weights_only=True)
    assert isinstance(ckpt["loader_state"], list) and len(ckpt["loader_state"]) == WORLD
    assert ranks[0]["drivers"]["grain"]["whole"]["writes"] == ["checkpoint-0.pth",
                                                               "checkpoint-1.pth"]
    assert all(not g["writes"] for g in ranks[1]["drivers"]["grain"].values())


def test_finetune_driver_at_world_size_2(runs):
    """``main_finetune`` at W = 2: the same losses and params on both ranks,
    one test score, and the checkpoints and ``checkpoint-best.pth`` written
    by rank 0 alone."""
    inp, refs, ranks = runs
    f0, f1 = (r["drivers"]["finetune"] for r in ranks)
    assert [e["steps"] for e in f0["history"]] == [2]
    assert f0["history"][0]["step_losses"] == f1["history"][0]["step_losses"]
    assert f0["test"] == f1["test"] and 0.0 <= f0["test"] <= 1.0
    _same_on_ranks(ranks, lambda r: r["drivers"]["finetune"]["params"])
    assert sorted(f0["writes"]) == ["checkpoint-0.pth", "checkpoint-best.pth"]
    assert f1["writes"] == []

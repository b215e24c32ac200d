"""The port's tools against the JAX package on the CPU: ``unpatchify``, the
stratified subsample, the diagnostics, the hub's ``MPMAE`` (and its
torch-hub entry), the reconstruction panels, the FLOP count, the profiling
helpers and the step timer, ``--wandb`` in both CLIs and ``--distributed``
at world size 1.  Small widths, seeded numpy inputs, f32; each tolerance is
stated where it is used."""
import math
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu import hub as jhub
from mmearth_tpu.checkpoints.torch_convert import torch_fcmae_to_flax
from mmearth_tpu.configs import modalities as JM
from mmearth_tpu.data.subsample import stratified_subsample_multilabel as jax_subsample
from mmearth_tpu.eval import visualize as jvis
from mmearth_tpu.losses import multipretext as jmp
from mmearth_tpu.models import fcmae as jfc
from mmearth_tpu.train import optim as joptim
from mmearth_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
from mmearth_tpu.train.step import TrainState, make_pretrain_step
from mmearth_tpu.utils.flops import step_flops as jax_step_flops
from mmearth_tpu_torch import hub, main_finetune, main_pretrain
from mmearth_tpu_torch.checkpoints.convert import from_jax_classifier, from_jax_fcmae
from mmearth_tpu_torch.data import geobench as gb
from mmearth_tpu_torch.data.subsample import stratified_subsample_multilabel
from mmearth_tpu_torch.data.synthetic import bench_batch, generate_packed, synthetic_batch
from mmearth_tpu_torch.eval import visualize
from mmearth_tpu_torch.losses.multipretext import patchify, unpatchify
from mmearth_tpu_torch.models.fcmae import FCMAE
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train.schedule import warmup_cosine
from mmearth_tpu_torch.train.step import ChainedStep, pretrain_step, to_device
from mmearth_tpu_torch.utils import diagnostics, flops, profiling
from mmearth_tpu_torch.utils.logging import maybe_wandb

from _torch_parity import close, np_tree, randomize_grn

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-4  # f32, relative to each output's largest magnitude: sums in another order
# a small FCMAE: 56/8 (7 x 7 patches, 19 visible), one block a stage
KW = dict(img_size=56, patch_size=8, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
          decoder_embed_dim=32, grn_group=2, inp_modalities=JM.INP_MODALITIES,
          out_modalities=JM.OUT_MODALITIES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fcmae_pair(seed=0, **kw):
    """The port's small FCMAE and its weights as a JAX param tree (GRN
    affines randomized: they init to zero, which hides GRN bugs)."""
    kw = {**KW, **kw}
    tm = FCMAE(**kw).init_weights(torch.Generator().manual_seed(seed))
    params = randomize_grn(jax.tree_util.tree_map(jnp.asarray, torch_fcmae_to_flax(
        {k: v.numpy().copy() for k, v in tm.state_dict().items()}, kw["depths"],
        JM.OUT_MODALITIES)), seed)
    tm.load_state_dict(from_jax_fcmae(np_tree(params), kw["depths"], JM.OUT_MODALITIES),
                       strict=True)
    return tm, jfc.FCMAE(**kw), params


# ---------------------------------------------------------------------------
# unpatchify, subsample, diagnostics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("img,p,c", [(16, 4, 3), (56, 8, 9)])
def test_unpatchify_matches_jax(img, p, c):
    """Bit-exact against JAX's, and the inverse of ``patchify``."""
    x = np.random.default_rng(img).normal(size=(2, img, img, c)).astype(np.float32)
    patches = patchify(torch.from_numpy(x), p)
    np.testing.assert_array_equal(unpatchify(patches, p, img, c).numpy(), x)
    ref = jmp.unpatchify(jnp.asarray(patches.numpy()), p, img, c)
    np.testing.assert_array_equal(unpatchify(patches, p, img, c).numpy(), np.asarray(ref))


def _labels(kind, seed):
    rng = np.random.default_rng(100 + seed)
    if kind == "multilabel":
        return [list(np.where(rng.random(5) < 0.4)[0]) or [0] for _ in range(120)]
    return rng.integers(0, 6, size=150) ** 2 % 7  # uneven class sizes


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kind,kw", [
    ("single", {"percentage": 0.5}), ("single", {"num_samples": 33}),
    ("multilabel", {"num_samples": 40, "multilabel": True, "classes": list(range(5))})])
def test_subsample_indices_match_jax(kind, kw, seed):
    """The chosen indices, in order, equal JAX's for the same seed."""
    y = _labels(kind, seed)
    got = stratified_subsample_multilabel(y, seed=seed, **kw)
    np.testing.assert_array_equal(got, jax_subsample(y, seed=seed, **kw))
    assert len(set(np.asarray(got).tolist())) == len(got)


def test_subsample_full_percentage_returns_y():
    """``percentage == 1`` returns ``y`` itself, as JAX's
    ``tests/test_subsample.py:42`` pins."""
    y = np.array([0, 1, 0, 1])
    assert stratified_subsample_multilabel(y, percentage=1) is y


def test_print_diagnostics_without_cuda(capsys, monkeypatch):
    """On a host without CUDA it says so and prints every package line in
    JAX's format ("name: version" or "name: not installed")."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    diagnostics.print_diagnostics()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("python: ") and out[1].startswith(f"torch: {torch.__version__}")
    assert "cuda: not available (no CUDA device)" in out
    assert "rank: 0  world size: 1" in out  # JAX's process_index / process_count
    assert any(line.startswith("nvcc: ") for line in out)
    for mod in ("numpy", "h5py", "array_record", "tensorboardX", "matplotlib", "wandb",
                "triton"):
        line = next(line for line in out if line.startswith(f"{mod}: "))
        assert line != f"{mod}: " and (mod != "numpy" or line == f"numpy: {np.__version__}")


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------
HUB_KW = dict(num_classes=10, in_chans=12, img_size=32, patch_size=8)


@pytest.fixture(scope="module")
def hub_ckpt(tmp_path_factory):
    """A pretraining .pth of convnextv2_atto at 32/8 written from a JAX FCMAE
    init (GRN affines randomized) through the port's converter."""
    m = jfc.convnextv2_atto(img_size=32, patch_size=8, inp_modalities=JM.INP_MODALITIES,
                            out_modalities=JM.OUT_MODALITIES)
    batch = {k: jnp.asarray(v) for k, v in synthetic_batch(2, 32, seed=0).items()}
    params = randomize_grn(jax.jit(m.init)({"params": jax.random.PRNGKey(0),
                                            "mask": jax.random.PRNGKey(1)}, batch)["params"],
                           seed=2)
    path = tmp_path_factory.mktemp("hub") / "pt-atto_32-8.pth"
    torch.save({"model": from_jax_fcmae(np_tree(params), (2, 2, 6, 2), JM.OUT_MODALITIES)}, path)
    return path


@pytest.mark.parametrize("probe", [False, True])
def test_mpmae_matches_jax(hub_ckpt, probe):
    """``MPMAE`` on the CPU against JAX's ``hub.MPMAE`` from the same file:
    every weight (encoder from the file, the final norm at init, the head
    re-drawn) equal, the logits within RTOL in f32, and the same params
    trainable (all; the head alone under the probe)."""
    model, trainable = hub.MPMAE("convnextv2_atto", linear_probe=probe, ckpt_path=hub_ckpt,
                                 device="cpu", **HUB_KW)
    jm, jparams, jtrainable = jhub.MPMAE("convnextv2_atto", linear_probe=probe,
                                         ckpt_path=hub_ckpt, **HUB_KW)
    ref = from_jax_classifier(np_tree(jparams), (2, 2, 6, 2))
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), ref[k].reshape(v.shape).numpy(), err_msg=k)
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 12)).astype(np.float32)
    with torch.no_grad():
        logits = model(torch.from_numpy(x)).numpy()
    close(logits, jm.apply({"params": jparams}, jnp.asarray(x)), "logits", RTOL)
    mask = joptim.zero_grads_mask(jparams, jtrainable)
    jax_trainable = sum(bool(t) for t in jax.tree_util.tree_leaves(mask))
    port_trainable = {n for n, p in model.named_parameters() if p.requires_grad}
    assert len(port_trainable) == jax_trainable
    assert port_trainable == ({"head.weight", "head.bias"} if probe
                              else {n for n, _ in model.named_parameters()})
    assert all(trainable(n) == (n in port_trainable) for n, _ in model.named_parameters())


def test_mpmae_through_torch_hub_in_a_fresh_interpreter(hub_ckpt):
    """``torch.hub.load(<repo>/mmearth_tpu_torch, "MPMAE", source="local")``
    from a fresh interpreter gives the model ``hub.MPMAE`` gives."""
    code = (
        "import sys, torch\n"
        f"m, _ = torch.hub.load({str(ROOT / 'mmearth_tpu_torch')!r}, 'MPMAE', source='local', "
        f"ckpt_path={str(hub_ckpt)!r}, device='cpu', num_classes=10, img_size=32)\n"
        "torch.save(m.state_dict(), sys.argv[1])\n")
    out = hub_ckpt.parent / "hub_loaded.pth"
    subprocess.run([sys.executable, "-c", code, str(out)], check=True, cwd=hub_ckpt.parent,
                   timeout=120)
    model, _ = hub.MPMAE(ckpt_path=hub_ckpt, device="cpu", num_classes=10, img_size=32)
    loaded = torch.load(out)
    assert all(torch.equal(v, loaded[k]) for k, v in model.state_dict().items())


# ---------------------------------------------------------------------------
# reconstruction panels
# ---------------------------------------------------------------------------
PIXEL_OUT = ("sentinel2", "sentinel1", "aster", "canopy_height_eth", "dynamic_world",
             "esa_worldcover")


def test_run_one_batch_matches_jax():
    """The maps of every pixel modality on JAX's mask against JAX's
    ``run_one_batch``, within RTOL in f32; the mask handed back unchanged."""
    tm, jm, params = _fcmae_pair(seed=4)
    batch = synthetic_batch(2, 56, seed=6)
    jmaps, jmask = jvis.run_one_batch(jm, params, {k: jnp.asarray(v) for k, v in batch.items()},
                                      jax.random.PRNGKey(5))
    maps, mask = visualize.run_one_batch(tm, batch, mask=jmask)
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    assert sorted(maps) == sorted(jmaps) == sorted(PIXEL_OUT)
    for k, v in jmaps.items():
        assert maps[k].shape == v.shape == (2, 56, 56, tm.out_chans[k])
        close(maps[k], v, f"map {k}", RTOL)
    # a drawn mask keeps num_visible patches in every row
    _, drawn = visualize.run_one_batch(tm, batch, generator=torch.Generator().manual_seed(1))
    assert ((drawn == 0).sum(1) == tm.num_visible).all()


def test_visualize_main_writes_the_panels(tmp_path):
    """``python -m mmearth_tpu_torch.eval.visualize --device cpu`` from a
    pretraining .pth on a packed split: one PNG for each pixel modality, and
    the checkpoint's decoder in the model that drew them."""
    data = generate_packed(tmp_path / "pack", n=8, tile=64, seed=0, splits=("train",))
    fc = FCMAE(img_size=56, patch_size=8, depths=(2, 2, 6, 2), dims=(40, 80, 160, 320),
               loss_aggr="uncertainty").init_weights(torch.Generator().manual_seed(9))
    torch.save({"model": fc.state_dict()}, tmp_path / "pt.pth")
    out = visualize.main(["--device", "cpu", "--ckpt", str(tmp_path / "pt.pth"),
                          "--data_dir", str(data / "train"), "--out", str(tmp_path / "panels")])
    assert sorted(p.stem for p in Path(out).glob("*.png")) == sorted(PIXEL_OUT)
    assert all(p.stat().st_size > 1000 for p in Path(out).glob("*.png"))
    model = FCMAE(img_size=56, patch_size=8, depths=(2, 2, 6, 2), dims=(40, 80, 160, 320),
                  loss_aggr="unweighted")
    visualize.load_fcmae(model, tmp_path / "pt.pth")
    assert torch.equal(model.proj.weight, fc.proj.weight)


def test_render_panels_refuses_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib is missing, ``render_panels`` raises naming it
    before it writes anything."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    tm, _, _ = _fcmae_pair()
    batch = synthetic_batch(2, 56, seed=6)
    maps, mask = visualize.run_one_batch(tm, batch)
    with pytest.raises(ImportError, match="matplotlib"):
        visualize.render_panels(tm, batch, maps, mask, tmp_path / "panels")
    assert not (tmp_path / "panels").exists()


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------
def test_step_flops_counts_products_and_convs():
    """The counter's convention on known shapes (JAX's ``tests/test_flops.py``):
    2 M N K a product, the two backward products of a matmul, 2 * outputs *
    taps * input channels a group for a convolution, depthwise included."""
    a, b = torch.zeros(8, 32), torch.zeros(32, 16)
    assert flops.step_flops(torch.mm, a, b) == 2 * 8 * 32 * 16
    assert flops.step_flops(torch.bmm, torch.zeros(4, 8, 32), torch.zeros(4, 32, 16)) \
        == 2 * 4 * 8 * 32 * 16
    x = torch.zeros(2, 12, 8, 8)
    assert flops.step_flops(torch.nn.functional.conv2d, x, torch.zeros(24, 12, 3, 3),
                            padding=1) == 2 * (2 * 8 * 8 * 24) * 3 * 3 * 12
    assert flops.step_flops(torch.nn.functional.conv2d, x, torch.zeros(12, 1, 3, 3), padding=1,
                            groups=12) == 2 * (2 * 8 * 8 * 12) * 3 * 3 * 1
    a.requires_grad_(), b.requires_grad_()
    assert flops.step_flops(lambda: (a @ b).sum().backward()) == 3 * 2 * 8 * 32 * 16


def _port_step_flops(n, tile, seed=5):
    model = FCMAE(**{**KW, "grn_group": n}).init_weights(torch.Generator().manual_seed(0))
    opt = toptim.AdamW(model.named_parameters(), warmup_cosine(1e-4, 0, 4, 1, 2), 0.05)
    batch = {k: torch.from_numpy(v) for k, v in synthetic_batch(n, tile, seed=seed).items()}
    return flops.step_flops(pretrain_step, model, opt, batch, 0,
                            torch.Generator().manual_seed(0))


def test_step_flops_against_jax():
    """One pretraining step (64-px tiles cropped to 56, forward, backward,
    AdamW) counted by the port on the CPU and by JAX's jaxpr walk, on the
    same config and weights.  They differ by exactly five terms, each
    computed here from the shapes:

    1. JAX's crop is two one-hot einsums over the pixel modalities' stacked
       channels (``fcmae.py:92-104``); the port crops by exact indexing.
    2. JAX's gathered encoder selects the visible patches by one-hot matmuls
       (``gather_impl`` "onehot", ``convnextv2.py:709``): the stem's gather,
       each block's scatter and gather, the final scatter, each with one
       backward product; the port selects by exact index ops.
    3. The port's plain dK of every dense 7 x 7 depthwise conv (the gathered
       dwconv's and the decoder's) sums 49 shifted products, elementwise
       work the counter does not see; JAX's is a convolution.
    4. ``FlopCounterMode`` counts the weight gradient of the grouped 1 x 1
       stem conv as if ungrouped, C0 times its products.
    5. JAX counts the dx of each stride-2 downsample as a convolution of
       the lhs-dilated gradient, whose zero taps it counts: 4x the forward.
    """
    n, tile, img, p = 2, 64, KW["img_size"], KW["patch_size"]
    depths, dims, d = KW["depths"], KW["dims"], KW["decoder_embed_dim"]
    raw = synthetic_batch(n, tile, seed=5)
    tm, jm, params = _fcmae_pair()
    tx = joptim.make_pretrain_optimizer(params, jax_warmup_cosine(1e-4, 0, 4, 1, 2), 0.05)
    jax_count = jax_step_flops(make_pretrain_step(jm, True), TrainState.create(params, tx),
                               {k: jnp.asarray(v) for k, v in raw.items()},
                               jax.random.PRNGKey(0))
    port_count = _port_step_flops(n, tile)

    grid = img // p
    L, K = grid * grid, int(grid * grid * (1 - 0.6))
    s = p // 2 ** (len(depths) - 1)  # stem stride
    side = [img // s // 2 ** i for i in range(4)]  # each stage's dense grid
    pp = [(h // grid) ** 2 for h in side]  # rows of a patch at each stage
    c_pix = sum(v.shape[-1] for k, v in raw.items()
                if v.ndim == 4 and k in JM.PIXEL_WISE_MODALITIES)
    crop = 2 * n * img * tile * tile * c_pix + 2 * n * img * img * c_pix * tile
    select = 2 * n * K * L  # a one-hot product's FLOPs per (patch row x channel)
    onehot = 2 * select * (pp[0] * dims[0] + sum(2 * dep * q * c for dep, q, c in
                                                 zip(depths, pp, dims)) + pp[3] * dims[3])
    dk = 2 * 49 * n * (sum(dep * h * h * c for dep, h, c in zip(depths, side, dims))
                       + grid * grid * d)
    stem_dw = (dims[0] - 1) * 2 * n * side[0] ** 2 * dims[0]
    down_dx = 3 * sum(2 * n * K * pp[i + 1] * dims[i + 1] * 4 * dims[i] for i in range(3))
    assert jax_count - port_count == crop + onehot + dk - stem_dw + down_dx
    assert (crop, onehot, dk, stem_dw, down_dx) == (44728320, 18590208, 9527168, 702464,
                                                    5603328)


def test_step_flops_are_linear_in_the_batch():
    """Batch 4 counts exactly twice batch 2 (the bench counts at a small
    batch and scales)."""
    assert _port_step_flops(4, 64) == 2 * _port_step_flops(2, 64)


def test_mfu_of_a_step():
    assert flops.mfu(989e12 * 0.03, 30.0) == pytest.approx(1.0)
    assert flops.mfu(2e9 * 256, 33.0) == pytest.approx(2e9 * 256 / 0.033 / 989e12)


# ---------------------------------------------------------------------------
# profiling and the step timer
# ---------------------------------------------------------------------------
def test_trace_summarize_and_attribute_on_cpu(tmp_path):
    """A trace of CPU work (JAX's ``tests/test_profiling.py:10``): the
    summary's rows are (name, ms >= 0, count) sorted by time, the matmul
    among them; the attribution buckets every CPU op by its group."""
    x = torch.ones(256, 256)
    with profiling.trace(tmp_path):
        for _ in range(3):
            torch.tanh(x @ x.T).sum()
    rows = profiling.summarize_trace(tmp_path, top=5, device="cpu")
    assert rows and all(len(r) == 3 and r[1] >= 0 and r[2] >= 1 for r in rows)
    assert [r[1] for r in rows] == sorted((r[1] for r in rows), reverse=True)
    assert any(name in ("aten::mm", "aten::matmul") and c == 3 for name, _, c in
               profiling.summarize_trace(tmp_path, top=50, device="cpu"))
    buckets = profiling.attribute_trace(tmp_path, device="cpu")
    total = sum(ms for _, ms, _ in profiling.summarize_trace(tmp_path, top=None, device="cpu"))
    assert sum(ms for _, ms in buckets) == pytest.approx(total)
    assert profiling.group_of("void patch_copy_bulk<true>(Config)") == \
        "patch gather/scatter (port kernel)"
    assert profiling.group_of("fwd_stat_kernel<bf16, 64, 1, SpillRows>") == \
        "spill-g fwd A (port kernel)"


def test_time_steps_runs():
    """JAX's ``tests/test_profiling.py:21``: a finite, positive ms/step."""
    best, rounds = profiling.time_steps(lambda i: torch.ones(8, 8).sum(), "cpu", k=3, rounds=2)
    assert len(rounds) == 2 and best == min(rounds) and math.isfinite(best) and best > 0


def test_time_steps_leaves_the_state_of_as_many_pretrain_steps():
    """``time_steps`` over a ``ChainedStep`` of k = 2 (a warm-up round and
    one timed round: 4 steps) leaves the params and AdamW state of 4
    ``pretrain_step`` calls, bit for bit."""
    batch = to_device(bench_batch(2, 64, seed=1), "cpu")
    states = []
    for chained in (False, True):
        model = FCMAE(**KW).init_weights(torch.Generator().manual_seed(0))
        opt = toptim.AdamW(model.named_parameters(), lambda n: 1e-3 / (1 + n))
        gen = torch.Generator().manual_seed(3)
        if chained:
            ch = ChainedStep(model, opt, {k: v.expand(2, *v.shape) for k, v in batch.items()})
            profiling.time_steps(lambda i: ch(i, gen), "cpu", k=2, rounds=1, per_call=2)
        else:
            for i in range(4):
                pretrain_step(model, opt, batch, i, gen)
        states.append((model.state_dict(), opt.state_dict()))
    (m1, o1), (m2, o2) = states
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert o1["count"] == o2["count"] == 4
    assert all(torch.equal(o1["mu"][k], o2["mu"][k]) for k in o1["mu"])


# ---------------------------------------------------------------------------
# --wandb and --distributed in both CLIs
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pretrain_data(tmp_path_factory):
    # 10 train + 1 val samples of 64-px tiles: 2 steps of batch 4 (drop_last)
    return generate_packed(tmp_path_factory.mktemp("mmpack"), n=11, tile=64, seed=0)


@pytest.fixture(scope="module")
def eurosat(tmp_path_factory):
    d = tmp_path_factory.mktemp("geobench")
    gb.generate_synthetic_geobench(d, "m-eurosat", (8, 4, 4))
    fc = FCMAE(img_size=56, patch_size=8, depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
    torch.save({"model": fc.init_weights(torch.Generator().manual_seed(0)).state_dict()},
               d / "pt.pth")
    return d


def _run(cli, pretrain_data, eurosat, *extra):
    """A 1-epoch CPU run of ``cli`` ("pretrain": atto 56/8, 2 steps of
    batch 4; "finetune": the atto classifier on m-eurosat, 2 steps)."""
    if cli == "pretrain":
        return main_pretrain.main(main_pretrain.get_args_parser().parse_args([
            "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
            "--batch_size", "4", "--device", "cpu", "--processed_dir", str(pretrain_data),
            "--epochs", "1", "--warmup_epochs", "1", *extra]))
    return main_finetune.main(main_finetune.get_args_parser().parse_args([
        "--device", "cpu", "--model", "convnextv2_atto", "--input_size", "56",
        "--patch_size", "8", "--data_set", "m-eurosat", "--processed_dir", str(eurosat),
        "--finetune", str(eurosat / "pt.pth"), "--batch_size", "4", "--epochs", "1", *extra]))


class _StubWandb(types.ModuleType):
    """A ``wandb`` that records its calls."""

    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw))

    def log(self, payload):
        self.calls.append(("log", dict(payload)))

    def finish(self):
        self.calls.append(("finish", None))


# JAX's payload keys: pretraining's train/pretrain.py:298-303 (the meters'
# loss and lr, the epoch, the last step's per-modality losses and the
# uncertainty weights); finetuning's log_stats, train/finetune.py:339-347
PRETRAIN_KEYS = ({"train_loss", "train_lr", "epoch"}
                 | {f"train_loss_{m}" for m in JM.OUT_MODALITIES}
                 | {f"log_var_{i}" for i in range(len(JM.OUT_MODALITIES))})
FINETUNE_KEYS = {"train_loss", "train_lr", "test_Accuracy", "epoch", "n_parameters"}


@pytest.mark.parametrize("cli", ["pretrain", "finetune"])
def test_wandb_calls_where_jax_makes_them(cli, pretrain_data, eurosat, monkeypatch):
    """``--wandb True`` with a ``wandb`` installed: ``init`` with the
    project and run name, one ``log`` an epoch with JAX's payload keys, and
    ``finish`` at the end of a finetune (JAX's pretraining never calls it)."""
    stub = _StubWandb()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    _run(cli, pretrain_data, eurosat, "--wandb", "True", "--wandb_project", "proj",
         "--wandb_run_name", "run1")
    kinds = [c[0] for c in stub.calls]
    assert kinds == (["init", "log"] if cli == "pretrain" else ["init", "log", "finish"])
    init = stub.calls[0][1]
    assert init["project"] == "proj" and init["name"] == "run1" and init["config"]["wandb"]
    payload = stub.calls[1][1]
    assert set(payload) == (PRETRAIN_KEYS if cli == "pretrain" else FINETUNE_KEYS)
    assert payload["epoch"] == 0 and all(math.isfinite(v) for v in payload.values())


def test_maybe_wandb_off_or_missing(capsys, monkeypatch):
    """Off: None and no import.  Missing: JAX's line, and None."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    assert maybe_wandb(False, "p", None, {}) is None
    assert capsys.readouterr().out == ""
    assert maybe_wandb(True, "p", None, {}) is None
    assert capsys.readouterr().out == "wandb not installed; continuing without it\n"


@pytest.mark.parametrize("cli", ["pretrain", "finetune"])
def test_wandb_missing_and_distributed_run_at_world_size_1(cli, pretrain_data, eurosat,
                                                           monkeypatch, capsys):
    """``--wandb True --distributed True`` where wandb is missing: JAX's
    line, then the run goes on to its end (world size 1, as JAX's CLIs
    run it)."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = _run(cli, pretrain_data, eurosat, "--wandb", "True", "--distributed", "True")
    assert "wandb not installed; continuing without it" in capsys.readouterr().out
    history = out[1] if cli == "pretrain" else out["history"]
    assert [e["steps"] for e in history] == [2]
    assert all(math.isfinite(v) for v in history[0]["step_losses"])


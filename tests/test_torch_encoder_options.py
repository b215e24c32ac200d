"""The encoder options of the port against the JAX package, in f32 on the CPU:
the tanh GELU (``gelu_approx``), the original stem (``use_orig_stem``), the
leaky dense encoder (``sparse=False``), ``block_impl`` "remat" and "folded",
and the stem on the gathered rows (``stem_gathered``); at the block, the
encoder and the FCMAE step; then through both drivers, their ``.pth``
checkpoints, and the routing that keeps the kernel tails off the paths
whose GELU they do not compute.

Tolerances: parity with JAX within 1e-4 of each output's scale and 1e-3 of
each FCMAE grad's (tests/test_torch_model.py's: the same f32 math summed in
other orders); the folded tail within JAX's own rtol 1e-4, atol 1e-5
(tests/test_block_impl.py); the rematerialized tail against the composed one
within 1e-6 (the same ops, run again)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.checkpoints.torch_convert import torch_encoder_to_flax
from mmearth_tpu.models import convnextv2 as jcnx
from mmearth_tpu_torch import main_finetune, main_pretrain
from mmearth_tpu_torch.checkpoints import load_pretrained as lp
from mmearth_tpu_torch.checkpoints import pth_io
from mmearth_tpu_torch.checkpoints.convert import _block, from_jax_encoder, to_tensors
from mmearth_tpu_torch.data import geobench as gb
from mmearth_tpu_torch.data.synthetic import generate_packed, synthetic_batch
from mmearth_tpu_torch.models import convnextv2 as tcnx
from mmearth_tpu_torch.models import fcmae as tfc
from mmearth_tpu_torch.train.optim import AdamW
from mmearth_tpu_torch.train.pretrain import build_model

from _torch_parity import (assert_fcmae_matches_jax, assert_grads_close, close,
                           encoder_grads_as_sd, fcmae_case, np_tree, random_mask, randomize_grn)

RTOL = 1e-4
DEPTHS, DIMS = (1, 1, 1, 1), (8, 16, 32, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Block level, against JAX's Block
# ---------------------------------------------------------------------------
def _block_inputs(form: str, n: int, c: int, rng):
    """(JAX args after x, port kwargs, JAX x, port x) of a block form:
    "gathered" (N, K, p, p, C) rows of a 4 x 4 grid of 2 x 2 patches, K = 6
    visible; "masked_dense" an 8 x 8 map, zero where masked; "dense" an 8 x 8
    map."""
    if form == "gathered":
        grid, p, k = 4, 2, 6
        mask = random_mask(rng, n, grid * grid, k)
        x = rng.normal(size=(n, k, p, p, c)).astype(np.float32)
        onehot = jcnx.visible_onehot(jnp.asarray(mask), k, jnp.float32)
        kept, inv = tcnx.visible_ids(torch.from_numpy(mask), k)
        return ((None, True, (("onehot", onehot), grid, grid * p)), {"gather": (kept, inv, grid)},
                x.reshape(n, k, p * p, c), x)
    x = rng.normal(size=(n, 8, 8, c)).astype(np.float32)
    if form == "dense":
        return (), {}, x, x
    keep = (rng.random((n, 8, 8, 1)) > 0.5).astype(np.float32)
    return (jnp.asarray(keep),), {"keep": torch.from_numpy(keep)}, x * keep, x * keep


def _block_sd(tree) -> dict:
    """A JAX Block's param (or grad) tree as the port's state dict, under "b."."""
    sd = {}
    _block(np_tree(tree), "b", sd)
    return to_tensors(sd)


def _port_block(params, c: int, **kw) -> tcnx.Block:
    """The port's Block holding the JAX Block's ``params``."""
    blk = tcnx.Block(c, **kw)
    blk.load_state_dict({k[2:]: v for k, v in _block_sd(params).items()}, strict=True)
    return blk


def _run_block(blk, x, kw, r):
    """The port's output, and its grads after sum(y * r) (dx, then params)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    y = blk(xt, **kw)
    (y * torch.from_numpy(r.reshape(y.shape))).sum().backward()
    return y.detach().numpy(), xt.grad.numpy()


def _block_case(form: str, n: int, c: int, seed: int, jax_kw: dict, port_kw: dict) -> dict:
    """A JAX Block (``jax_kw``) and the port's (``port_kw``) on the same
    params and input: the port's Block, its output and dx (``got``), JAX's
    (``ref``), JAX's param grads as the port's state dict (``ref_grads``)
    and the port's input (``x``, ``kw``, ``r``)."""
    rng = np.random.default_rng(seed)
    jargs, tkw, xj, xt = _block_inputs(form, n, c, rng)
    sparse = form != "dense"
    jb = jcnx.Block(c, sparse=sparse, **jax_kw)
    params = jb.init(jax.random.PRNGKey(0), jnp.asarray(xj), *jargs)["params"]
    params["grn"]["gamma"] = jnp.asarray(rng.normal(size=(4 * c,)).astype(np.float32))
    params["grn"]["beta"] = jnp.asarray(rng.normal(size=(4 * c,)).astype(np.float32))
    r = rng.normal(size=xj.shape).astype(np.float32)

    def loss(p, x):
        y = jb.apply({"params": p}, x, *jargs)
        return jnp.sum(y * r), y

    (_, y_ref), (g_ref, dx_ref) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1),
                                                            has_aux=True))(params, jnp.asarray(xj))
    blk = _port_block(params, c, sparse=sparse, **port_kw)
    y, dx = _run_block(blk, xt, tkw, r)
    return {"blk": blk, "got": (y, dx),
            "ref": (np.asarray(y_ref).reshape(y.shape), np.asarray(dx_ref).reshape(dx.shape)),
            "ref_grads": _block_sd(g_ref), "x": xt, "kw": tkw, "r": r}


def _assert_block_matches(case: dict) -> None:
    (y, dx), (y_ref, dx_ref) = case["got"], case["ref"]
    close(y, y_ref, "y", RTOL)
    close(dx, dx_ref, "dx", RTOL)
    assert_grads_close(case["blk"], case["ref_grads"], RTOL, prefix="b.")


FORMS = ("gathered", "masked_dense", "dense")


@pytest.mark.parametrize("form", FORMS)
def test_remat_block_matches_jax(form):
    """``Block(remat=True)`` against JAX's ``Block(block_impl="remat")`` in
    every form: output, dx and every param grad."""
    _assert_block_matches(_block_case(form, 2, 16, 2, {"block_impl": "remat"}, {"remat": True}))


@pytest.mark.parametrize("form", FORMS)
def test_remat_block_equals_the_composed_block(form):
    """The rematerialized tail is the composed tail run again in the
    backward: output within 1e-6 (JAX's test_block_impl tolerance), and
    every grad within 1e-5 of its scale, of the same Block without remat."""
    rng = np.random.default_rng(5)
    _, tkw, _, x = _block_inputs(form, 2, 16, rng)
    r = rng.normal(size=x.shape).astype(np.float32)
    sparse = form != "dense"
    out = {}
    for remat in (False, True):
        torch.manual_seed(0)
        blk = tcnx.Block(16, sparse=sparse, remat=remat)
        with torch.no_grad():
            blk.grn.gamma.normal_()
            blk.grn.beta.normal_()
        out[remat] = blk, _run_block(blk, x, tkw, r)
    (b0, (y0, dx0)), (b1, (y1, dx1)) = out[False], out[True]
    np.testing.assert_allclose(y1, y0, rtol=1e-6, atol=1e-6)
    close(dx1, dx0, "dx", 1e-5)
    for (name, p0), (_, p1) in zip(b0.named_parameters(), b1.named_parameters()):
        close(p1.grad.numpy(), p0.grad.numpy(), name, 1e-5)


@pytest.mark.parametrize("group", [0, 2])
def test_folded_block_matches_jax(group):
    """``Block(folded=True)`` on the gathered rows against JAX's
    ``Block(block_impl="folded")`` (``_folded_tail``), one GRN group of the
    batch and one per two samples: output, dx and every param grad within
    JAX's folded tolerance (rtol 1e-4, atol 1e-5); and the output against
    the port's composed tail on the same params, the same."""
    case = _block_case("gathered", 4, 16, 3, {"block_impl": "folded", "grn_group": group},
                       {"folded": True, "grn_group": group})
    blk, (y, dx), (y_ref, dx_ref) = case["blk"], case["got"], case["ref"]
    assert blk.folded
    np.testing.assert_allclose(y, y_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dx, dx_ref, rtol=1e-4, atol=1e-5)
    assert_grads_close(blk, case["ref_grads"], RTOL, prefix="b.")
    plain = tcnx.Block(16, sparse=True, grn_group=group)
    plain.load_state_dict(blk.state_dict())
    y_plain, _ = _run_block(plain, case["x"], case["kw"], case["r"])
    np.testing.assert_allclose(y, y_plain, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("form,impl", [("gathered", "wholeblock"), ("masked_dense", "fused"),
                                       ("dense", "auto")])
def test_gelu_approx_block_matches_jax(form, impl):
    """``Block(gelu_approx=True)`` against JAX's ``Block(gelu_approx=True)``
    in every form, each with the kernel tail of its form requested
    (``wholeblock``'s spill-g, masked-dense ``fused``): the port composes the
    tail, as JAX declines its kernels, so both compute the tanh GELU."""
    port_kw = {"gelu_approx": True, "spillg": impl == "wholeblock", "fused": impl == "fused"}
    case = _block_case(form, 2, 16, 4, {"block_impl": impl, "gelu_approx": True}, port_kw)
    assert not (case["blk"].spillg or case["blk"].fused)
    _assert_block_matches(case)


def test_gelu_is_the_gelu_of_jax():
    """Both GELUs against ``jax.nn.gelu`` on [-6, 6] in f32, within a few
    f32 ulps of 6 (the two evaluate tanh and erf differently)."""
    v = np.linspace(-6, 6, 1001).astype(np.float32)
    for approx in (False, True):
        got = tcnx.gelu(torch.from_numpy(v), approx).numpy()
        np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(v, approximate=approx)),
                                   rtol=1e-6, atol=2e-6)


# ---------------------------------------------------------------------------
# Encoder level, against JAX's ConvNeXtV2.encode
# ---------------------------------------------------------------------------
def _assert_encoder_matches_jax(img, patch, opts, jax_kw=None, port_kw=None, gathered=True,
                                seed=0):
    """``encode(x, mask, K)`` of the port's ConvNeXtV2 with ``opts`` (and
    ``port_kw``) against JAX's with ``opts`` (and ``jax_kw``), the gathered
    path when ``gathered`` (else no visible count): output and every param
    grad.  Returns the port's output."""
    n, c_in, grid = 2, 12, img // patch
    k = int(grid * grid * 0.4)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, img, img, c_in)).astype(np.float32)
    mask = random_mask(rng, n, grid * grid, k)
    kw = dict(patch_size=patch, img_size=img, in_chans=c_in, depths=DEPTHS, dims=DIMS,
              grn_group=n, **opts)
    tm = tcnx.ConvNeXtV2(**kw, **(port_kw or {}))
    tm.init_weights(torch.Generator().manual_seed(0))
    sd = {key: v.numpy() for key, v in tm.state_dict().items()}
    params = randomize_grn(jax.tree_util.tree_map(jnp.asarray, torch_encoder_to_flax(
        sd, DEPTHS, opts.get("use_orig_stem", False), include_head=False)))
    jm = jcnx.ConvNeXtV2(**{"sparse": True, **kw}, num_classes=0, **(jax_kw or {}))
    r = rng.normal(size=(n, grid, grid, DIMS[-1])).astype(np.float32)
    nv = k if gathered else None

    @jax.jit
    def loss(p):
        y = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask),
                     method=lambda mod, a, b: mod.encode(a, b, num_visible=nv))
        return jnp.sum(y * r), y

    (_, y_ref), g_ref = jax.value_and_grad(loss, has_aux=True)(params)
    tm.load_state_dict(to_tensors(from_jax_encoder(np_tree(params), DEPTHS)), strict=True)
    y = tm.encode(torch.from_numpy(x), torch.from_numpy(mask), nv)
    (y * torch.from_numpy(r)).sum().backward()
    close(y.detach().numpy(), y_ref, "encode", RTOL)
    assert_grads_close(tm, encoder_grads_as_sd(g_ref, DEPTHS), RTOL)
    return y.detach()


@pytest.mark.parametrize("block_impl", ["auto", "remat"])
def test_leaky_encoder_matches_jax(block_impl):
    """``ConvNeXtV2(sparse=False).encode``: the mask on the input only, the
    dense stem and stages (dense GRN, ``dwconv7x7``), against JAX's leaky
    path; it builds no norm and no head, and its masked sites are not zero."""
    y = _assert_encoder_matches_jax(56, 8, {"sparse": False, "block_impl": block_impl},
                                    seed=1)
    tm = tcnx.ConvNeXtV2(depths=DEPTHS, dims=DIMS, sparse=False)
    assert not hasattr(tm, "head") and not hasattr(tm, "norm")
    assert float(y.abs().min()) > 0


@pytest.mark.parametrize("sparse_impl", ["gathered", "masked_dense"])
@pytest.mark.parametrize("img,patch", [(56, 8), (112, 16)])
def test_orig_stem_encoder_matches_jax(img, patch, sparse_impl):
    """The original stem (an s x s stride-s conv -> LN, s = 1 at 56/8 and 2
    at 112/16) on the gathered and the masked-dense encoders."""
    _assert_encoder_matches_jax(img, patch, {"use_orig_stem": True, "sparse_impl": sparse_impl},
                                gathered=sparse_impl == "gathered", seed=img)
    tm = tcnx.ConvNeXtV2(img_size=img, patch_size=patch, use_orig_stem=True)
    assert tm.stem_orig[0].weight.shape == (40, 12, patch // 8, patch // 8)
    assert not hasattr(tm, "stem") and not hasattr(tm, "initial_conv")


@pytest.mark.parametrize("use_orig_stem", [False, True])
def test_stem_gathered_matches_jax(use_orig_stem):
    """``stem_gathered``: the stem's site-local part on the gathered rows,
    against JAX's (tests/test_gathered_encoder.py:115-140) and against the
    port's dense stem."""
    opts = {"use_orig_stem": use_orig_stem}
    y = _assert_encoder_matches_jax(56, 8, {**opts, "stem_gathered": True}, seed=4)
    y_dense = _assert_encoder_matches_jax(56, 8, opts, seed=4)
    np.testing.assert_allclose(y.numpy(), y_dense.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sparse_impl,port_impl", [("gathered", "wholeblock"),
                                                   ("masked_dense", "fused"),
                                                   ("gathered", "folded")])
def test_gelu_approx_encoder_matches_jax(sparse_impl, port_impl):
    """``gelu_approx`` in the stem and every block tail.  The port asks for
    the kernel tail of its path and composes it instead; folded takes the
    tanh GELU in its fold, as JAX's does."""
    jax_impl = "folded" if port_impl == "folded" else "xla"
    _assert_encoder_matches_jax(56, 8, {"gelu_approx": True, "sparse_impl": sparse_impl},
                                jax_kw={"block_impl": jax_impl},
                                port_kw={"block_impl": port_impl},
                                gathered=sparse_impl == "gathered", seed=6)


# ---------------------------------------------------------------------------
# FCMAE step, against JAX
# ---------------------------------------------------------------------------
FCMAE_OPTIONS = {
    "leaky": {"sparse": False},
    "orig_stem": {"use_orig_stem": True},
    "remat": {"block_impl": "remat"},
    "folded": {"block_impl": "folded"},
    "stem_gathered": {"stem_gathered": True},
    "orig_stem_gathered": {"use_orig_stem": True, "stem_gathered": True},
}


@pytest.mark.parametrize("option", list(FCMAE_OPTIONS))
def test_fcmae_step_matches_jax(option):
    """The f32 FCMAE step with each option, on the mask JAX's FCMAE drew:
    every prediction, every per-modality loss, the total, and every param
    grad (JAX's grads with that mask given explicitly)."""
    c = fcmae_case(4, 64, 56, 8, DEPTHS, DIMS, **FCMAE_OPTIONS[option])
    tm = tfc.FCMAE(**c["kw"])
    assert_fcmae_matches_jax(c, tm, c["out"])


def test_fcmae_gelu_approx_on_the_kernel_path_matches_jax():
    """``gelu_approx`` with ``wholeblock`` asked for: the step equals JAX's
    (composed, the tanh GELU in the stem, the block tails and the decoder
    Block), and no block of the port takes the spill-g tail."""
    c = fcmae_case(4, 64, 56, 8, DEPTHS, DIMS, gelu_approx=True)
    tm = tfc.FCMAE(**{**c["kw"], "block_impl": "wholeblock"})
    assert not any(blk.spillg for stage in tm.encoder.stages for blk in stage)
    assert_fcmae_matches_jax(c, tm, c["out"])


# ---------------------------------------------------------------------------
# Launch routing: the kernel tails stay off the paths that decline them
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sparse_impl,block_impl,extra", [
    ("gathered", "wholeblock", {"gelu_approx": True}),
    ("gathered", "remat", {}),
    ("gathered", "folded", {}),
    ("masked_dense", "fused", {"gelu_approx": True}),
    ("gathered", "wholeblock", {"sparse": False}),
])
def test_declined_paths_call_no_kernel_tail(monkeypatch, sparse_impl, block_impl, extra):
    """A step of each path that declines the kernel tails calls neither
    ``fused_block_mlp_spillg`` nor ``fused_block_mlp``; the gathered ones
    still take the gathered dwconv, the leaky one only the dense dwconv."""
    calls = {"spillg": 0, "fused": 0, "gathered": 0, "dense": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    for key, name in (("spillg", "fused_block_mlp_spillg"), ("fused", "fused_block_mlp"),
                      ("gathered", "dwconv7_gathered"), ("dense", "dwconv7x7")):
        monkeypatch.setattr(tcnx, name, counting(key, getattr(tcnx, name)))
    m = tfc.FCMAE(img_size=56, patch_size=8, depths=DEPTHS, dims=DIMS, decoder_embed_dim=32,
                  grn_group=2, block_impl=block_impl, sparse_impl=sparse_impl, **extra)
    m.init_weights(torch.Generator().manual_seed(0))
    batch = tfc.zero_nan_inputs({k: torch.from_numpy(v)
                                 for k, v in synthetic_batch(2, 56, seed=0).items()})
    loss = m(batch, generator=torch.Generator().manual_seed(0))[0]
    loss.backward()
    assert math.isfinite(float(loss.detach()))
    assert calls["spillg"] == calls["fused"] == 0
    blocks = sum(DEPTHS)
    if extra.get("sparse", True) and sparse_impl == "gathered":
        assert (calls["gathered"], calls["dense"]) == (blocks, 1)  # + the decoder Block
    else:
        assert (calls["gathered"], calls["dense"]) == (0, blocks + 1)


# ---------------------------------------------------------------------------
# Drivers and checkpoints
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # 10 train + 1 val samples of 64-px tiles: 2 steps of batch 4 (drop_last)
    return generate_packed(tmp_path_factory.mktemp("mmpack"), n=11, tile=64, seed=0)


def _pretrain_args(data, *extra):
    return main_pretrain.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--batch_size", "4", "--device", "cpu", "--processed_dir", str(data), "--epochs", "1",
        "--warmup_epochs", "1", *extra])


DRIVER_FLAGS = {
    "gelu_approx": ["--gelu_approx", "True", "--block_impl", "wholeblock"],
    "orig_stem": ["--use_orig_stem", "True", "--block_impl", "wholeblock"],
    "leaky": ["--sparse", "False"],
    "remat": ["--block_impl", "remat"],
    "folded": ["--block_impl", "folded"],
}


@pytest.mark.parametrize("option", list(DRIVER_FLAGS))
def test_main_pretrain_option_runs_two_steps_and_resumes_on_cpu(data, tmp_path, option):
    """Two CPU steps of ``main_pretrain`` in bf16 with each flag (none is
    refused): finite losses; its ``checkpoint-0.pth`` strict-loads into a
    fresh model of the same flags and holds the run's params bit for bit
    (``stem_orig.*`` with the original stem, no encoder norm or head with
    the leaky encoder)."""
    args = _pretrain_args(data, *DRIVER_FLAGS[option], "--output_dir", str(tmp_path))
    model, history, opt = main_pretrain.main(args)
    assert [e["steps"] for e in history] == [2]
    assert all(math.isfinite(v) for v in history[0]["step_losses"])
    cfg = main_pretrain.config_from_args(args)
    fresh = build_model(cfg, "cpu")
    fresh_opt = AdamW(fresh.named_parameters(), opt.lr_schedule)
    assert pth_io.restore(tmp_path / "checkpoint-0.pth", fresh, fresh_opt) == 0
    ours, theirs = model.state_dict(), fresh.state_dict()
    assert set(ours) == set(theirs)
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    keys = set(ours)
    if option == "orig_stem":
        assert {"encoder.stem_orig.0.weight", "encoder.stem_orig.1.bias"} <= keys
        assert not any(k.startswith(("encoder.stem.", "encoder.initial_conv.")) for k in keys)
    if option == "leaky":
        assert not any(k.startswith(("encoder.head", "encoder.norm")) for k in keys)
        assert not model.encoder.sparse
    if option == "gelu_approx":
        assert not any(blk.spillg for stage in model.encoder.stages for blk in stage)


def test_main_finetune_from_an_orig_stem_checkpoint_on_cpu(data, tmp_path):
    """An original-stem pretraining run's ``checkpoint-0.pth`` bootstraps
    ``main_finetune --use_orig_stem True``: the classifier's ``stem_orig.*``
    are the checkpoint's, and a CPU epoch of 3 steps has finite losses."""
    pre = tmp_path / "pre"
    main_pretrain.main(_pretrain_args(data, "--use_orig_stem", "True", "--output_dir", str(pre)))
    ckpt = pre / "checkpoint-0.pth"
    geo = tmp_path / "geo"
    gb.generate_synthetic_geobench(geo, "m-eurosat", (12, 4, 4))
    args = main_finetune.get_args_parser().parse_args([
        "--device", "cpu", "--model", "convnextv2_atto", "--input_size", "56",
        "--patch_size", "8", "--processed_dir", str(geo), "--finetune", str(ckpt),
        "--batch_size", "4", "--epochs", "1", "--use_orig_stem", "True", "--drop_path", "0.1",
        "--linear_probe", "True"])
    out = main_finetune.main(args)
    (epoch,) = out["history"]
    assert epoch["steps"] == 3 and all(math.isfinite(v) for v in epoch["step_losses"])
    enc = lp.encoder_state_from_checkpoint(ckpt, out["model"].depths)
    assert {"stem_orig.0.weight", "stem_orig.0.bias", "stem_orig.1.weight"} <= set(enc)
    sd = out["model"].state_dict()
    assert all(torch.equal(sd[k], v) for k, v in enc.items())  # frozen under the probe


def test_squeezed_orig_stem_weight_loads(tmp_path):
    """A 1x1 original-stem weight (s = 1) stored squeezed, (C, in), takes the
    model's (C, in, 1, 1) in a resume and in a finetune bootstrap."""
    model = tfc.FCMAE(img_size=56, patch_size=8, depths=DEPTHS, dims=DIMS, decoder_embed_dim=32,
                      use_orig_stem=True).init_weights(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    w = sd["encoder.stem_orig.0.weight"]
    assert w.shape == (8, 12, 1, 1)
    squeezed = {**sd, "encoder.stem_orig.0.weight": w.reshape(8, 12)}
    torch.save({"model": squeezed}, tmp_path / "pt.pth")
    fresh = tfc.FCMAE(img_size=56, patch_size=8, depths=DEPTHS, dims=DIMS, decoder_embed_dim=32,
                      use_orig_stem=True)
    assert pth_io.restore(tmp_path / "pt.pth", fresh) is None
    assert torch.equal(fresh.state_dict()["encoder.stem_orig.0.weight"], w)
    enc = lp.encoder_state_from_checkpoint(tmp_path / "pt.pth", DEPTHS)
    assert torch.equal(enc["stem_orig.0.weight"], w)

"""The port's gathered and masked-dense encoders and FCMAE against the JAX
package, in f32 on the CPU, with JAX's weights carried across by the port's
converter.

Tolerances: outputs and grads within 1e-4 of their scale (atol = rtol *
max|ref|).  Both sides compute the same f32 math; the sums (GRN statistics
over the batch, convs, matmuls) run in other orders, and the JAX FCMAE with an
explicit mask takes its masked-dense encoder, whose GRN sums also include
the zeros of the masked sites."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.checkpoints.torch_convert import (flax_fcmae_to_torch, torch_encoder_to_flax,
                                                   torch_fcmae_to_flax)
from mmearth_tpu.configs import modalities as JM
from mmearth_tpu.models import convnextv2 as jcnx
from mmearth_tpu.models import fcmae as jfc
from mmearth_tpu_torch.checkpoints.convert import from_jax_encoder, from_jax_fcmae, to_tensors
from mmearth_tpu_torch.data.synthetic import synthetic_batch
from mmearth_tpu_torch.models import convnextv2 as tcnx
from mmearth_tpu_torch.models import fcmae as tfc

from _torch_parity import (assert_grads_close, encoder_grads_as_sd, fcmae_grads_as_sd, np_tree,
                           random_mask, randomize_grn)

RTOL = 1e-4
DEPTHS, DIMS = (1, 1, 1, 1), (8, 16, 32, 64)


def _close(got, ref, what, rtol=RTOL):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-6), err_msg=what)


@pytest.mark.parametrize("img_size,patch_size", [(56, 8), (112, 16)])
@pytest.mark.parametrize("jax_impl", ["xla", "dwg", "wholeblock"])
def test_encoder_matches_jax(img_size, patch_size, jax_impl):
    """``encode(x, mask, K)`` against ConvNeXtV2.encode(x, mask, num_visible=K)
    (the JAX gathered path; dwg runs its Pallas dwconv kernel in interpret
    mode at p = 8), output and every param grad.  wholeblock: the port runs
    its spill-g tail with one GRN group of the batch, and JAX runs with
    grn_group=0 so that its spill-g Pallas kernels (interpret mode) really run
    (they decline grn_group != 0); one group of all N samples is the same
    statistic."""
    n, c_in, grid = 2, 12, img_size // patch_size
    k = int(grid * grid * 0.4)
    rng = np.random.default_rng(img_size)
    x = rng.normal(size=(n, img_size, img_size, c_in)).astype(np.float32)
    mask = random_mask(rng, n, grid * grid, k)
    kw = dict(patch_size=patch_size, img_size=img_size, in_chans=c_in, depths=DEPTHS, dims=DIMS,
              grn_group=n)
    port_impl = "wholeblock" if jax_impl == "wholeblock" else "auto"
    jm = jcnx.ConvNeXtV2(**{**kw, "grn_group": 0 if jax_impl == "wholeblock" else n},
                         num_classes=0, sparse=True, block_impl=jax_impl)
    tm = tcnx.ConvNeXtV2(**kw, block_impl=port_impl)
    tm.init_weights(torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = randomize_grn(jax.tree_util.tree_map(
        jnp.asarray, torch_encoder_to_flax(sd, DEPTHS, include_head=False)))
    r = rng.normal(size=(n, grid, grid, DIMS[-1])).astype(np.float32)

    @jax.jit
    def loss(p):
        y = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask),
                     method=lambda mod, a, b: mod.encode(a, b, num_visible=k))
        return jnp.sum(y * r), y

    (_, y_ref), g_ref = jax.value_and_grad(loss, has_aux=True)(params)

    tm.load_state_dict(to_tensors(from_jax_encoder(np_tree(params), DEPTHS)), strict=True)
    y = tm.encode(torch.from_numpy(x), torch.from_numpy(mask), k)
    (y * torch.from_numpy(r)).sum().backward()
    _close(y.detach().numpy(), y_ref, "encode")
    assert_grads_close(tm, encoder_grads_as_sd(g_ref, DEPTHS), RTOL)


@pytest.mark.parametrize("port_impl", ["auto", "fused"])
@pytest.mark.parametrize("ragged", [False, True])
def test_masked_dense_encoder_matches_jax(port_impl, ragged):
    """``ConvNeXtV2(sparse_impl="masked_dense").encode`` against JAX's
    masked-dense ``encode(x, mask)`` (the dense 7x7 dwconv, the keep-masked
    stem, downsamples and block tails), output and every param grad.  fused:
    the port runs ``fused_block_mlp`` with one GRN group of the batch, and
    JAX runs with grn_group=0 so that its Pallas kernel (interpret mode)
    really runs (``_fused_active`` declines grn_group != 0).  ragged: a mask
    keeping 12/19/25/31 patches per sample, which only this path takes."""
    n, c_in, img, grid = 4, 12, 56, 7
    rng = np.random.default_rng(11 + ragged)
    x = rng.normal(size=(n, img, img, c_in)).astype(np.float32)
    ks = (12, 19, 25, 31) if ragged else (19,) * n
    mask = np.concatenate([random_mask(rng, 1, grid * grid, k) for k in ks])
    kw = dict(patch_size=8, img_size=img, in_chans=c_in, depths=DEPTHS, dims=DIMS, grn_group=n)
    jm = jcnx.ConvNeXtV2(**{**kw, "grn_group": 0 if port_impl == "fused" else n},
                         num_classes=0, sparse=True, sparse_impl="masked_dense",
                         block_impl=port_impl)
    tm = tcnx.ConvNeXtV2(**kw, block_impl=port_impl, sparse_impl="masked_dense")
    tm.init_weights(torch.Generator().manual_seed(0))
    assert all(blk.fused == (port_impl == "fused") for stage in tm.stages for blk in stage)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = randomize_grn(jax.tree_util.tree_map(
        jnp.asarray, torch_encoder_to_flax(sd, DEPTHS, include_head=False)))
    r = rng.normal(size=(n, grid, grid, DIMS[-1])).astype(np.float32)

    @jax.jit
    def loss(p):
        y = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask),
                     method=lambda mod, a, b: mod.encode(a, b))
        return jnp.sum(y * r), y

    (_, y_ref), g_ref = jax.value_and_grad(loss, has_aux=True)(params)

    tm.load_state_dict(to_tensors(from_jax_encoder(np_tree(params), DEPTHS)), strict=True)
    y = tm.encode(torch.from_numpy(x), torch.from_numpy(mask), None if ragged else 19)
    (y * torch.from_numpy(r)).sum().backward()
    _close(y.detach().numpy(), y_ref, "encode")
    assert_grads_close(tm, encoder_grads_as_sd(g_ref, DEPTHS), RTOL)


@pytest.mark.parametrize("block_impl,match", [("remat", "rematerialized"),
                                              ("folded", "norm-folded")])
def test_block_impl_outside_the_slice_raises(block_impl, match):
    with pytest.raises(ValueError, match=match):
        tcnx.ConvNeXtV2(block_impl=block_impl)


@pytest.fixture(scope="module")
def fcmae_case():
    """A small JAX FCMAE (all 12 output modalities), params made by the port's
    init and carried into flax by mmearth_tpu's converter, a 64-px
    synthetic batch cropped to 56 by JAX from a key, and JAX's own forward
    with a random mask drawn from a key."""
    n, tile, img = 4, 64, 56
    kw = dict(img_size=img, patch_size=8, depths=DEPTHS, dims=DIMS, decoder_embed_dim=32,
              grn_group=n, inp_modalities=JM.INP_MODALITIES, out_modalities=JM.OUT_MODALITIES)
    jm = jfc.FCMAE(**kw)
    raw = synthetic_batch(n, tile, seed=3)
    key = jax.random.PRNGKey(7)
    crop_key, mask_key = jax.random.split(key)
    cropped = jfc.zero_nan_inputs(jfc.aligned_random_crop(
        crop_key, {k: jnp.asarray(v) for k, v in raw.items()}, img))
    init = tfc.FCMAE(**kw).init_weights(torch.Generator().manual_seed(0))
    params = torch_fcmae_to_flax({k: v.numpy() for k, v in init.state_dict().items()}, DEPTHS,
                                 JM.OUT_MODALITIES)
    params = randomize_grn(jax.tree_util.tree_map(jnp.asarray, params), seed=1)
    params["log_vars"] = jnp.asarray(np.linspace(-0.5, 0.5, 12).astype(np.float32))
    out = jax.jit(lambda p, b: jm.apply({"params": p}, b, rngs={"mask": mask_key}))(
        params, cropped)
    return dict(kw=kw, jm=jm, raw=raw, crop_key=crop_key, cropped=cropped, params=params,
                out=out, n=n, img=img)


def test_crop_offsets_from_the_same_key(fcmae_case):
    """aligned_random_crop with the offsets JAX draws from the key
    (fcmae.py:87-89) is exact indexing.  It equals the JAX crop wherever that
    one is not NaN: the JAX crop is a one-hot matmul, so a NaN pixel (a
    no-data canopy_height_eth value) turns its whole channel NaN (0 * NaN),
    and zero_nan_inputs then zeros that channel; indexing keeps the channel."""
    c = fcmae_case
    ky, kx = jax.random.split(c["crop_key"])
    tops = np.array(jax.random.randint(ky, (c["n"],), 0, 64 - 56 + 1))
    lefts = np.array(jax.random.randint(kx, (c["n"],), 0, 64 - 56 + 1))
    got = tfc.aligned_random_crop({k: torch.from_numpy(v) for k, v in c["raw"].items()},
                                  c["img"], tops=torch.from_numpy(tops),
                                  lefts=torch.from_numpy(lefts))
    ref = jfc.aligned_random_crop(c["crop_key"], {k: jnp.asarray(v) for k, v in c["raw"].items()},
                                  c["img"])
    ar = np.arange(c["img"])
    for k, v in c["raw"].items():
        g = got[k].numpy()
        if v.ndim == 4:
            exact = v[np.arange(c["n"])[:, None, None], (tops[:, None] + ar)[:, :, None],
                      (lefts[:, None] + ar)[:, None, :]]
            np.testing.assert_array_equal(g, exact, err_msg=k)
        r = np.asarray(ref[k])
        seen = ~np.isnan(r) if r.dtype.kind == "f" else np.ones(r.shape, bool)
        np.testing.assert_array_equal(g[seen], r[seen], err_msg=k)


@pytest.mark.parametrize("block_impl", ["auto", "wholeblock"])
def test_fcmae_forward_loss_and_grads_match_jax(fcmae_case, block_impl):
    """The port's FCMAE with the mask JAX's FCMAE.__call__ drew: every
    prediction, every per-modality loss, the total, and every param grad.
    wholeblock runs the port's spill-g tail; the converter's param tree
    strict-loads into it as into auto."""
    c = fcmae_case
    _assert_fcmae_matches_jax(c, tfc.FCMAE(**c["kw"], block_impl=block_impl), c["out"])


def _assert_fcmae_matches_jax(c, tm, out, mask=None):
    """The port's FCMAE ``tm`` with JAX's params and ``out``'s mask (or
    ``mask``) against JAX's ``out`` (predictions, per-modality losses, total)
    and against the grads of JAX's FCMAE with that mask as an explicit mask
    (its masked-dense encoder)."""
    loss_ref, preds_ref, out_mask, ld_ref, _, _ = out
    mask = out_mask if mask is None else mask
    tm.load_state_dict(from_jax_fcmae(np_tree(c["params"]), DEPTHS, JM.OUT_MODALITIES),
                       strict=True)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in c["cropped"].items()}
    loss, preds, _, ld, log_vars, _ = tm(batch, mask=torch.from_numpy(np.array(mask)))
    loss.backward()
    for k, v in preds_ref.items():
        _close(preds[k].detach().numpy(), v, f"pred {k}")
    for k, v in ld_ref.items():
        _close(float(ld[k].detach()), v, f"loss {k}")
    _close(float(loss.detach()), loss_ref, "loss")

    def loss_fn(p):
        return c["jm"].apply({"params": p}, c["cropped"], mask=mask)[0]

    g_ref = jax.jit(jax.grad(loss_fn))(c["params"])
    assert_grads_close(tm, fcmae_grads_as_sd(g_ref, DEPTHS, JM.OUT_MODALITIES), 1e-3)


@pytest.mark.parametrize("block_impl", ["auto", "fused"])
def test_fcmae_masked_dense_matches_jax(fcmae_case, block_impl):
    """``FCMAE(sparse_impl="masked_dense")`` with the mask JAX drew (K
    visible in every row, so the configured encoder runs): predictions,
    losses and every param grad; fused runs the plain ``fused_block_mlp``."""
    c = fcmae_case
    tm = tfc.FCMAE(**c["kw"], block_impl=block_impl, sparse_impl="masked_dense")
    assert tm.encoder.sparse_impl == "masked_dense"
    _assert_fcmae_matches_jax(c, tm, c["out"])


@pytest.mark.parametrize("block_impl", ["auto", "wholeblock"])
def test_ragged_explicit_mask_runs_masked_dense(fcmae_case, block_impl):
    """A mask keeping 12/19/25/31 patches (not K = 19 in every row) takes the
    masked-dense encoder whatever the configured path, as JAX's
    ``forward_encoder`` sends every explicit mask there: the port against
    JAX's ``FCMAE(..., mask=m)``, predictions, losses and grads."""
    c = fcmae_case
    rng = np.random.default_rng(21)
    mask = jnp.asarray(np.concatenate([random_mask(rng, 1, 49, k) for k in (12, 19, 25, 31)]))
    out = jax.jit(lambda p, b: c["jm"].apply({"params": p}, b, mask=mask))(
        c["params"], c["cropped"])
    _assert_fcmae_matches_jax(c, tfc.FCMAE(**c["kw"], block_impl=block_impl), out, mask)


def test_converter_matches_flax_fcmae_to_torch(fcmae_case):
    """from_jax_fcmae emits the keys, shapes and values of
    flax_fcmae_to_torch(target="fcmae"), and strict-loads into the port."""
    c = fcmae_case
    got = from_jax_fcmae(np_tree(c["params"]), DEPTHS, JM.OUT_MODALITIES)
    ref = flax_fcmae_to_torch(c["params"], DEPTHS, JM.OUT_MODALITIES, target="fcmae")
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert tuple(got[k].shape) == tuple(np.shape(v)), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v, np.float32), err_msg=k)
    tm = tfc.FCMAE(**c["kw"])
    assert set(tm.state_dict()) == set(got)
    tm.load_state_dict(got, strict=True)


def test_init_rules():
    """trunc-normal std 1 for the sparse dwconv/pw, the proj and the pixel
    heads; normal .02 for the rest; zero biases, GRN affines and log_vars."""
    tm = tfc.FCMAE(img_size=56, patch_size=8, depths=(1, 1, 1, 1), dims=(16, 32, 64, 128),
                   decoder_embed_dim=64).init_weights(torch.Generator().manual_seed(0))
    sd = tm.state_dict()
    w = sd["encoder.stages.3.0.pwconv1.weight"]
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 + 1e-6
    assert 0.9 < float(w.std()) < 1.1
    assert abs(float(sd["encoder.downsample_layers.0.1.weight"].std()) - 0.02) < 0.005
    assert abs(float(sd["decoder_dict.sentinel2.0.pwconv1.weight"].std()) - 0.02) < 0.005
    assert 0.9 < float(sd["pred_dict.sentinel2.weight"].std()) < 1.1
    for k, v in sd.items():
        if k.endswith("bias") or ".grn." in k or k == "loss_fn.log_vars":
            assert float(v.abs().max()) == 0.0, k

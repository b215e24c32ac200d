"""Shared helpers of the tests that hold the PyTorch port (``mmearth_tpu_torch``)
against the JAX package: inputs made with numpy from a seed, JAX params
carried into the port through its own converter, and comparison of
state-dict-shaped gradients."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mmearth_tpu.checkpoints.torch_convert import torch_fcmae_to_flax
from mmearth_tpu.configs import modalities as JM
from mmearth_tpu.models import fcmae as jfc
from mmearth_tpu_torch.checkpoints.convert import from_jax_encoder, from_jax_fcmae, to_tensors
from mmearth_tpu_torch.data.synthetic import synthetic_batch
from mmearth_tpu_torch.models import fcmae as tfc


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def random_mask(rng: np.random.Generator, n: int, num_patches: int, keep: int) -> np.ndarray:
    """(N, L) float32 mask (1 = removed) with exactly ``keep`` zeros per row."""
    mask = np.ones((n, num_patches), np.float32)
    for i in range(n):
        mask[i, rng.permutation(num_patches)[:keep]] = 0.0
    return mask


def randomize_grn(params, seed: int = 0):
    """Non-identity GRN affines (they init to zero, which hides GRN bugs)."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        keys = [str(getattr(p, "key", p)) for p in path]
        if "grn" in keys:
            return jax.numpy.asarray(0.5 * rng.normal(size=leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(fix, params)


def encoder_grads_as_sd(grads, depths):
    return to_tensors(from_jax_encoder(np_tree(grads), depths))


def fcmae_grads_as_sd(grads, depths, out_modalities):
    return from_jax_fcmae(np_tree(grads), depths, out_modalities)


def assert_grads_close(port_module: torch.nn.Module, ref_sd: dict, rtol: float, prefix: str = ""):
    """Each param's .grad against the reference, relative to the reference's
    largest magnitude (atol = rtol * max|ref|)."""
    seen = 0
    for name, prm in port_module.named_parameters():
        key = prefix + name
        if key not in ref_sd:
            continue
        ref = ref_sd[key].reshape(prm.shape)
        got = prm.grad if prm.grad is not None else torch.zeros_like(prm)
        scale = float(ref.abs().max()) or 1.0
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=rtol,
                                   atol=rtol * scale, err_msg=key)
        seen += 1
    assert seen > 0


def close(got, ref, what, rtol):
    """``got`` within ``rtol`` of ``ref``, relative to ref's largest magnitude."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-6), err_msg=what)


def fcmae_case(n, tile, img, patch, depths, dims, **opts):
    """A small JAX FCMAE (all 12 output modalities, FCMAE options ``opts``),
    params made by the port's init and carried into flax by mmearth_tpu's
    converter, a synthetic batch cropped to ``img`` by JAX from a key, and
    JAX's own forward with a random mask drawn from a key.  ``kw`` holds
    the constructor arguments for the port's FCMAE."""
    kw = dict(img_size=img, patch_size=patch, depths=depths, dims=dims, decoder_embed_dim=32,
              grn_group=n, inp_modalities=JM.INP_MODALITIES, out_modalities=JM.OUT_MODALITIES,
              **opts)
    jm = jfc.FCMAE(**kw)
    raw = synthetic_batch(n, tile, seed=3)
    key = jax.random.PRNGKey(7)
    crop_key, mask_key = jax.random.split(key)
    cropped = jfc.zero_nan_inputs(jfc.aligned_random_crop(
        crop_key, {k: jnp.asarray(v) for k, v in raw.items()}, img))
    init = tfc.FCMAE(**kw).init_weights(torch.Generator().manual_seed(0))
    params = torch_fcmae_to_flax({k: v.numpy() for k, v in init.state_dict().items()}, depths,
                                 JM.OUT_MODALITIES,
                                 use_orig_stem=opts.get("use_orig_stem", False))
    params = randomize_grn(jax.tree_util.tree_map(jnp.asarray, params), seed=1)
    params["log_vars"] = jnp.asarray(np.linspace(-0.5, 0.5, 12).astype(np.float32))
    out = jax.jit(lambda p, b: jm.apply({"params": p}, b, rngs={"mask": mask_key}))(
        params, cropped)
    return dict(kw=kw, jm=jm, raw=raw, crop_key=crop_key, cropped=cropped,
                params=params, out=out, n=n, img=img, depths=depths)


def assert_fcmae_matches_jax(c, tm, out, mask=None, rtol=1e-4, grad_rtol=1e-3):
    """The port's FCMAE ``tm`` with JAX's params and ``out``'s mask (or
    ``mask``) against JAX's ``out`` (predictions, per-modality losses, total)
    and against the grads of JAX's FCMAE with that mask as an explicit mask
    (its masked-dense encoder)."""
    loss_ref, preds_ref, out_mask, ld_ref, _, _ = out
    mask = out_mask if mask is None else mask
    depths = c["depths"]
    tm.load_state_dict(from_jax_fcmae(np_tree(c["params"]), depths, JM.OUT_MODALITIES),
                       strict=True)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in c["cropped"].items()}
    loss, preds, _, ld, log_vars, _ = tm(batch, mask=torch.from_numpy(np.array(mask)))
    loss.backward()
    for k, v in preds_ref.items():
        close(preds[k].detach().numpy(), v, f"pred {k}", rtol)
    for k, v in ld_ref.items():
        close(float(ld[k].detach()), v, f"loss {k}", rtol)
    close(float(loss.detach()), loss_ref, "loss", rtol)

    def loss_fn(p):
        return c["jm"].apply({"params": p}, c["cropped"], mask=mask)[0]

    g_ref = jax.jit(jax.grad(loss_fn))(c["params"])
    assert_grads_close(tm, fcmae_grads_as_sd(g_ref, depths, JM.OUT_MODALITIES), grad_rtol)

"""The port's LayerNorm / GRN / MaskedGRN against mmearth_tpu.models.norm, in f32:
outputs and input/param grads within 1e-5 of their scale (the same f32
arithmetic in another summation order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.models import norm as jn
from mmearth_tpu_torch.models import norm as tn

TOL = 1e-5


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * max(1.0, np.abs(ref).max()),
                               err_msg=what)


def _run_both(jmod, tmod, x, keep=None, gamma=None, beta=None):
    jargs = (jnp.asarray(x),) + (() if keep is None else (jnp.asarray(keep),))
    params = jmod.init(jax.random.PRNGKey(0), *jargs)["params"]
    if gamma is not None:
        params = {"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)}
        with torch.no_grad():
            tmod.gamma.copy_(torch.from_numpy(gamma).reshape(tmod.gamma.shape))
            tmod.beta.copy_(torch.from_numpy(beta).reshape(tmod.beta.shape))
    dy = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    y, vjp = jax.vjp(lambda p, a: jmod.apply({"params": p}, a, *jargs[1:]), params, jargs[0])
    gp, gx = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    targs = () if keep is None else (torch.from_numpy(keep),)
    yt = tmod(xt, *targs)
    yt.backward(torch.from_numpy(dy))
    _close(yt.detach().numpy(), y, "output")
    _close(xt.grad.numpy(), gx, "dx")
    return gp


def test_layernorm():
    x = np.random.default_rng(0).normal(2.0, 3.0, size=(3, 5, 5, 16)).astype(np.float32)
    ln = tn.LayerNorm(16)
    gp = _run_both(jn.LayerNorm(16), ln, x)
    _close(ln.weight.grad.numpy(), gp["scale"], "scale")
    _close(ln.bias.grad.numpy(), gp["bias"], "bias")


def test_dense_grn_with_a_zero_channel():
    """Channel 3 is all zero: its L2 is 0, where the port (like _safe_l2) has
    a zero gradient instead of NaN."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 4, 8)).astype(np.float32)
    x[..., 3] = 0.0
    g, b = rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    grn = tn.GRN(8)
    gp = _run_both(jn.GRN(8), grn, x, gamma=g, beta=b)
    for name in ("gamma", "beta"):
        got = getattr(grn, name).grad.reshape(-1).numpy()
        assert np.isfinite(got).all()
        _close(got, gp[name], name)


@pytest.mark.parametrize("group", [0, 2])
def test_masked_grn_gathered_rows(group):
    """Gathered rows (N, K, p, p, C), every row visible (keep = ones), with
    global and grouped statistics."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 3, 2, 2, 8)).astype(np.float32)
    x[..., 5] = 0.0  # a dead channel
    keep = np.ones(x.shape[:-1] + (1,), np.float32)
    g, b = rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    grn = tn.MaskedGRN(8, group=group)
    gp = _run_both(jn.MaskedGRN(8, group=group), grn, x, keep=keep, gamma=g, beta=b)
    _close(grn.gamma.grad.reshape(-1).numpy(), gp["gamma"], "gamma")
    _close(grn.beta.grad.reshape(-1).numpy(), gp["beta"], "beta")


def test_masked_grn_keep_mask_and_group_fallback():
    """A masked dense map with a group that does not divide the batch: warns
    and falls back to whole-batch statistics, like the JAX layer."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 4, 4, 8)).astype(np.float32)
    keep = (rng.random((3, 4, 4, 1)) > 0.5).astype(np.float32)
    g, b = rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    with pytest.warns(UserWarning, match="not divisible"):
        _run_both(jn.MaskedGRN(8, group=2), tn.MaskedGRN(8, group=2), x, keep=keep,
                  gamma=g, beta=b)


def test_safe_l2_zero_gradient_at_zero():
    s = torch.tensor([0.0, 4.0], requires_grad=True)
    tn._safe_l2(s).sum().backward()
    np.testing.assert_array_equal(s.grad.numpy(), [0.0, 0.25])

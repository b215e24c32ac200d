"""The port's multi-pretext losses against mmearth_tpu.losses.multipretext:
each family, with NaN targets and empty valid sets, values and pred grads in
f32 within 1e-5 of their scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.losses import multipretext as jl
from mmearth_tpu_torch.losses import multipretext as tl

TOL = 1e-5
N, G, P = 3, 4, 2  # batch, patch grid, patch size
L = G * G


def _both(jfn, tfn, pred, *rest):
    jv, jg = jax.value_and_grad(lambda p: jfn(p, *[jnp.asarray(r) for r in rest]))(
        jnp.asarray(pred))
    pt = torch.from_numpy(pred).requires_grad_()
    tv = tfn(pt, *[torch.from_numpy(r) for r in rest])
    tv.backward()
    tv = float(tv.detach())
    np.testing.assert_allclose(tv, float(jv), rtol=TOL, atol=TOL)
    g = np.asarray(jg)
    np.testing.assert_allclose(pt.grad.numpy(), g, rtol=TOL, atol=TOL * max(1.0, np.abs(g).max()))
    return tv


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _mask(rng):
    return (rng.random((N, L)) > 0.4).astype(np.float32)


def test_image_categorical(rng):
    pred = rng.normal(size=(N, 14)).astype(np.float32)
    target = np.eye(14, dtype=np.int32)[rng.integers(0, 14, N)]
    _both(jl.image_categorical_loss, tl.image_categorical_loss, pred, target)


@pytest.mark.parametrize("all_nan", [False, True])
def test_image_continuous_nan(rng, all_nan):
    pred = rng.normal(size=(N, 12)).astype(np.float32)
    target = rng.normal(size=(N, 12)).astype(np.float32)
    target[rng.random(target.shape) < 0.3] = np.nan
    if all_nan:
        target[:] = np.nan
    v = _both(jl.image_continuous_loss, tl.image_continuous_loss, pred, target)
    assert (v == 0.0) == all_nan


@pytest.mark.parametrize("empty", [False, True])
def test_pixel_categorical(rng, empty):
    c = 9
    pred = rng.normal(size=(N, L, P * P * c)).astype(np.float32)
    target = rng.integers(-1, c, size=(N, G * P, G * P, 1)).astype(np.int32)
    mask = np.zeros((N, L), np.float32) if empty else _mask(rng)
    v = _both(lambda p, t, m: jl.pixel_categorical_loss(p, t, m, P, c),
              lambda p, t, m: tl.pixel_categorical_loss(p, t, m, P, c), pred, target, mask)
    assert (v == 0.0) == empty


@pytest.mark.parametrize("norm_pix", [False, True])
def test_pixel_continuous_nan_patches(rng, norm_pix):
    """One patch is entirely zero-error (dropped from the nonzero-patch
    denominator); NaNs are zeroed on the input path so targets are finite."""
    c = 3
    target = rng.normal(size=(N, G * P, G * P, c)).astype(np.float32)
    pred = rng.normal(size=(N, L, P * P * c)).astype(np.float32)
    pred[0, 0] = jl.patchify(jnp.asarray(target), P)[0, 0]  # exact patch: zero loss
    _both(lambda p, t, m: jl.pixel_continuous_loss(p, t, m, P, norm_pix),
          lambda p, t, m: tl.pixel_continuous_loss(p, t, m, P, norm_pix),
          pred, target, _mask(rng))


def test_pixel_continuous_nan_counted_forward(rng):
    """NaN targets: a patch whose elements are all NaN is NaN and drops out;
    partly NaN patches average their valid elements (forward value; the JAX
    gradient through a NaN target is NaN there, so only the value is held)."""
    c = 2
    target = rng.normal(size=(N, G * P, G * P, c)).astype(np.float32)
    target[0, :P, :P, :] = np.nan
    target[1, 0, 0, 0] = np.nan
    pred = rng.normal(size=(N, L, P * P * c)).astype(np.float32)
    mask = np.ones((N, L), np.float32)
    jv = jl.pixel_continuous_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask), P)
    tv = tl.pixel_continuous_loss(torch.from_numpy(pred), torch.from_numpy(target),
                                  torch.from_numpy(mask), P)
    np.testing.assert_allclose(float(tv), float(jv), rtol=TOL)
    assert np.isfinite(float(tv))


def test_aggregations_zero_dropped_tasks(rng):
    losses = {"a": np.float32(1.5), "b": np.float32(0.0), "c": np.float32(0.25)}
    log_vars = rng.normal(size=3).astype(np.float32)
    jv, jw = jl.uncertainty_weighted({k: jnp.asarray(v) for k, v in losses.items()},
                                     jnp.asarray(log_vars))
    tv, tw = tl.uncertainty_weighted({k: torch.tensor(v) for k, v in losses.items()},
                                     torch.from_numpy(log_vars))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=TOL)
    assert float(tw[1]) == 0.0
    np.testing.assert_allclose(float(tv), float(jv), rtol=TOL)
    uv, _ = tl.unweighted({k: torch.tensor(v) for k, v in losses.items()})
    np.testing.assert_allclose(float(uv), float(jl.unweighted(
        {k: jnp.asarray(v) for k, v in losses.items()})[0]), rtol=TOL)


def test_patchify_order():
    x = np.arange(2 * 8 * 8 * 3, dtype=np.float32).reshape(2, 8, 8, 3)
    np.testing.assert_array_equal(tl.patchify(torch.from_numpy(x), 4).numpy(),
                                  np.asarray(jl.patchify(jnp.asarray(x), 4)))

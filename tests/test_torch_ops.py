"""The port's patch gather/scatter and dwconv7_gathered against the JAX ops.

On the CPU the port runs the plain versions of its CUDA kernels; they are held
here against ``mmearth_tpu.ops.patch_select`` (its jnp path off-TPU) and
``mmearth_tpu.ops.wholeblock`` (the Pallas kernel in interpret mode, and its
reference).  The kernels themselves are held against these plain versions on
the GPU (``chip_smoke.py`` and ``tests/test_torch_gpu.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.models.convnextv2 import visible_ids as jax_visible_ids
from mmearth_tpu.ops import patch_select as jps
from mmearth_tpu.ops.wholeblock import dwconv7_gathered as jax_dwg
from mmearth_tpu.ops.wholeblock import dwconv7_gathered_reference
from mmearth_tpu_torch.models.convnextv2 import visible_ids
from mmearth_tpu_torch.ops import patch_select as ps
from mmearth_tpu_torch.ops import wholeblock as wb

from _torch_parity import random_mask

N, GRID, K = 4, 7, 19


@pytest.fixture(scope="module")
def ids():
    mask = random_mask(np.random.default_rng(0), N, GRID * GRID, K)
    kept, inv = visible_ids(torch.from_numpy(mask), K)
    jkept, jinv = jax_visible_ids(jnp.asarray(mask), K)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(jkept))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    return kept, inv, jkept


@pytest.mark.parametrize("h,c", [(56, 8), (28, 16), (14, 32), (7, 24)])
def test_gather_scatter_bit_exact(ids, h, c):
    kept, inv, jkept = ids
    p = h // GRID
    x = np.random.default_rng(h).normal(size=(N, h, h, c)).astype(np.float32)
    got = ps.gather_patches(torch.from_numpy(x), kept, inv, p, GRID)
    ref = np.asarray(jps.gather_patches(jnp.asarray(x), jkept, p, GRID))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = ps.scatter_patches(got, kept, inv, p, GRID, h)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jps.scatter_patches(
        jnp.asarray(ref), jkept, p, GRID, h)))


def test_gather_scatter_vjps_are_each_other(ids):
    """Grads through gather -> *2 -> scatter -> square-sum match jax.vjp exactly."""
    kept, inv, jkept = ids
    h, c, p = 28, 8, 4
    x = np.random.default_rng(2).normal(size=(N, h, h, c)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = ps.scatter_patches(ps.gather_patches(xt, kept, inv, p, GRID) * 2.0, kept, inv, p, GRID, h)
    dy = np.random.default_rng(3).normal(size=y.shape).astype(np.float32)
    y.backward(torch.from_numpy(dy))

    def f(x):
        return jps.scatter_patches(jps.gather_patches(x, jkept, p, GRID) * 2.0, jkept, p, GRID, h)

    _, vjp = jax.vjp(f, jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,c", [(8, 8), (4, 16), (2, 16), (1, 24)])
def test_dwconv7_gathered_matches_jax(ids, p, c, dtype):
    """Forward and all three VJP outputs against the interpret-mode Pallas
    kernel and, in f32, against dwconv7_gathered_reference.  f32: unit-normal
    inputs, atol = rtol = 1e-5 of the output scale (the interpret kernel
    itself is within 7.6e-6 of the reference).  bf16: against the interpret
    kernel, which does the same arithmetic (taps rounded to bf16, f32
    accumulation and f32 bias, one rounding of the output): out and dx within
    one bf16 ulp of the output scale (2**-7), dK and db (f32 sums of the same
    bf16 products in another order) within 1e-4 of their scale.  The XLA
    reference is left out in bf16: it rounds its conv output and sums its
    bias gradient in bf16.
    """
    kept, inv, jkept = ids
    rng = np.random.default_rng(p * 100 + c)
    x = rng.normal(size=(N, K, p, p, c)).astype(np.float32)
    w = rng.normal(size=(7, 7, 1, c)).astype(np.float32)  # flax HWIO taps
    b = rng.normal(size=(c,)).astype(np.float32)
    dt = rng.normal(size=(N, K, p, p, c)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    out = wb.dwconv7_gathered(xt, kept, inv, wt, bt, GRID)
    out.backward(torch.from_numpy(dt).to(tdt))
    got = [out.float(), xt.grad.float(), wt.grad.permute(2, 3, 1, 0), bt.grad]

    xj, dtj = jnp.asarray(x, jdt), jnp.asarray(dt, jdt)
    refs = [lambda a, k_, b_: jax_dwg(a, jkept, k_, b_, GRID, True)]
    if dtype == "float32":
        refs.append(lambda a, k_, b_: dwconv7_gathered_reference(a, jkept, k_, b_, GRID))
    for fn in refs:
        o, vjp = jax.vjp(fn, xj, jnp.asarray(w), jnp.asarray(b))
        ref = [o] + list(vjp(dtj))
        for name, g, r in zip(["out", "dx", "dK", "db"], got, ref):
            r = np.asarray(r, np.float32)
            g = g.detach().numpy()
            if dtype == "float32":
                np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(r).max()),
                                           err_msg=name)
            else:
                tol = 2.0 ** -7 if name in ("out", "dx") else 1e-4
                np.testing.assert_allclose(g, r, rtol=0, atol=tol * np.abs(r).max(),
                                           err_msg=name)


def test_only_cpu_tensors_take_the_plain_path(ids):
    """Only a CPU tensor takes the plain version; any other device goes to the
    kernel (CUDA) or raises, checked here with the meta device."""
    kept, inv, _ = ids
    x = torch.empty(N, 56, 56, 8, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        ps._gather(x, kept, 8, GRID)
    with pytest.raises(RuntimeError, match="no kernel"):
        wb.dwconv7_gathered_fwd(torch.empty(N, K, 8, 8, 8, device="meta"), kept, inv,
                                torch.empty(8, 1, 7, 7), torch.empty(8), GRID)

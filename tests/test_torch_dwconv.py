"""The port's dense depthwise 7x7 conv (``mmearth_tpu_torch/ops/dwconv.py``)
and the dense Block that runs it, against the JAX package on the CPU.

The plain weight gradient is held against JAX's Pallas kernel
(``dw_weight_grad(..., interpret=True)``) and its jnp reference at the
geometries of ``tests/test_dwconv_kernel.py`` plus H = 7 (the halo larger
than the map); ``dwconv7x7``'s three grads against ``jax.grad`` of JAX's
``dwconv7x7(..., interpret=True)``; the dense Block (the classifier's and the
decoder's) against JAX ``Block(sparse=False)``.  f32 throughout; every
tolerance is stated where it is used.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.models import convnextv2 as jcnx
from mmearth_tpu.ops import dwconv as jdw
from mmearth_tpu_torch.checkpoints.convert import _block, to_tensors
from mmearth_tpu_torch.models.convnextv2 import Block, DropPath
from mmearth_tpu_torch.ops import dwconv as dw

from _torch_parity import np_tree


def _hwio_to_oihw(w):
    return np.asarray(w).transpose(3, 2, 0, 1)


def _close(got, ref, rtol, what=""):
    """Within ``rtol`` of each value plus ``rtol`` of the reference's scale."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=rtol * max(float(np.abs(ref).max()), 1e-12), err_msg=what)


@pytest.mark.parametrize("n,h,c", [(4, 14, 16), (3, 8, 40), (3, 7, 24), (2, 7, 5)])
def test_weight_grad_plain_matches_jax(n, h, c):
    """f32 sums of the same products in another order (the Pallas kernel's
    per-tap VMEM accumulator, jnp's stacked sums, torch's reductions): within
    1e-5 of each value plus 1e-5 of the largest."""
    rng = np.random.default_rng(n * h + c)
    x = rng.normal(size=(n, h, h, c)).astype(np.float32)
    dy = rng.normal(size=(n, h, h, c)).astype(np.float32)
    got = dw.dw_weight_grad_plain(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.shape == (c, 1, 7, 7) and got.dtype == torch.float32
    pallas = jdw.dw_weight_grad(jnp.asarray(x), jnp.asarray(dy), interpret=True)
    ref = jdw.dw_weight_grad_reference(jnp.asarray(x), jnp.asarray(dy))
    _close(got.numpy(), _hwio_to_oihw(pallas), 1e-5, "against the interpret-mode kernel")
    _close(got.numpy(), _hwio_to_oihw(ref), 1e-5, "against dw_weight_grad_reference")
    # on a CPU tensor the wrapper is the plain version and launches nothing
    before = dict(dw.LAUNCHES)
    assert torch.equal(dw.dw_weight_grad(torch.from_numpy(x), torch.from_numpy(dy)), got)
    assert dw.LAUNCHES == before


def test_dwconv7x7_grads_match_jax():
    """Output and x/w/b grads against ``jax.grad`` of JAX ``dwconv7x7`` (its
    dW from the interpret-mode Pallas kernel): within 1e-5 of the scale."""
    n, h, c = 2, 10, 12
    rng = np.random.default_rng(1)
    x = rng.normal(size=(n, h, h, c)).astype(np.float32)
    w = (0.1 * rng.normal(size=(7, 7, 1, c))).astype(np.float32)
    b = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    dy = rng.normal(size=(n, h, h, c)).astype(np.float32)

    def loss(x_, w_, b_):
        y = jdw.dwconv7x7(x_, w_, b_, True)
        return jnp.vdot(y, jnp.asarray(dy)), y

    (_, y_ref), (gx, gw, gb) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(_hwio_to_oihw(w).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = dw.dwconv7x7(xt, wt, bt)
    y.backward(torch.from_numpy(dy))
    _close(y.detach().numpy(), y_ref, 1e-5, "y")
    _close(xt.grad.numpy(), gx, 1e-5, "dx")
    _close(wt.grad.numpy(), _hwio_to_oihw(gw), 1e-5, "dW")
    _close(bt.grad.numpy(), gb, 1e-5, "db")


def test_frozen_weight_skips_the_weight_gradient(monkeypatch):
    """With the weight frozen (the linear probe's trunk) the backward computes
    no dW: neither the kernel nor its plain version runs."""
    calls = []
    monkeypatch.setattr(dw, "dw_weight_grad", lambda *a: calls.append(a))
    x = torch.randn(2, 8, 8, 4, requires_grad=True)
    w, b = torch.randn(4, 1, 7, 7), torch.randn(4, requires_grad=True)
    dw.dwconv7x7(x, w, b).sum().backward()
    assert not calls and x.grad is not None and b.grad is not None


@pytest.mark.parametrize("c,h", [(16, 9), (40, 7)])
def test_dense_block_matches_jax(c, h):
    """The dense Block (dwconv7x7 -> LN -> Linear -> GELU -> GRN -> Linear ->
    residual) against JAX ``Block(sparse=False)``: output and every param and
    input grad within 1e-4 of the scale (f32 sums in another order)."""
    n = 3
    rng = np.random.default_rng(c)
    x = rng.normal(size=(n, h, h, c)).astype(np.float32)
    r = rng.normal(size=(n, h, h, c)).astype(np.float32)
    jb = jcnx.Block(c, sparse=False)
    params = jb.init(jax.random.PRNGKey(c), jnp.asarray(x))["params"]
    grn = {k: jnp.asarray(0.5 * rng.normal(size=(4 * c,)).astype(np.float32))
           for k in ("gamma", "beta")}  # non-identity GRN affines
    params = {**params, "grn": grn}

    def loss(p, x_):
        y = jb.apply({"params": p}, x_)
        return jnp.sum(y * jnp.asarray(r)), y

    (_, y_ref), (g_ref, gx_ref) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))

    def as_sd(tree):
        sd = {}
        _block(np_tree(tree), "b", sd)
        return {k[2:]: v for k, v in to_tensors(sd).items()}

    tb = Block(c, sparse=False)
    tb.load_state_dict(as_sd(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_()
    y = tb(xt)
    (y * torch.from_numpy(r)).sum().backward()
    _close(y.detach().numpy(), y_ref, 1e-4, "y")
    _close(xt.grad.numpy(), gx_ref, 1e-4, "dx")
    ref = as_sd(g_ref)
    for name, prm in tb.named_parameters():
        _close(prm.grad.numpy(), ref[name].reshape(prm.shape).numpy(), 1e-4, name)


def test_drop_path_identity_at_rate_zero_and_without_a_generator():
    x = torch.randn(4, 3, 3, 2)
    gen = torch.Generator().manual_seed(0)
    assert DropPath(0.0)(x, gen) is x
    assert DropPath(0.5)(x) is x  # evaluation: no generator
    # the classifier's blocks: rates from linspace(0, rate, sum(depths)), JAX :632-634
    from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2

    m = ConvNeXtV2(depths=(1, 1, 2, 1), dims=(8, 8, 8, 8), sparse=False, num_classes=3,
                   drop_path_rate=0.4)
    rates = [blk.drop_path.rate for stage in m.stages for blk in stage]
    np.testing.assert_allclose(rates, np.linspace(0.0, 0.4, 5), rtol=0, atol=1e-7)


def test_drop_path_per_sample_mask_and_scale():
    """Each sample's branch is either all zero or all scaled by 1/keep, and
    the kept fraction over many samples is near keep (binomial, 5 sigma)."""
    rate, n = 0.3, 4000
    x = torch.rand(n, 2, 2, 3) + 0.5
    y = DropPath(rate)(x, torch.Generator().manual_seed(1))
    kept = (y != 0).flatten(1)
    assert bool((kept.all(1) | (~kept).all(1)).all())  # one decision per sample
    k = kept.all(1)
    torch.testing.assert_close(y[k], x[k] / (1 - rate), rtol=1e-6, atol=0)
    sigma = (n * rate * (1 - rate)) ** 0.5
    assert abs(int(k.sum()) - n * (1 - rate)) < 5 * sigma
    # the same generator state draws the same mask
    y2 = DropPath(rate)(x, torch.Generator().manual_seed(1))
    assert torch.equal(y, y2)


H100_OPTIN = 232448  # shared memory a block may opt in to on an H100 (227 KB)
H100_SMS = 132
# (N, H, C) of every launch of the weight-gradient kernel on the port's paths:
# the finetune step's four stages (batch 32), the masked-dense step's four and
# the decoder's (batch 256), huge's widest stage, ragged maps and an odd C
_PLAN_SHAPES = [(32, 64, 40), (32, 32, 80), (32, 16, 160), (32, 8, 320),
                (256, 56, 40), (256, 28, 80), (256, 14, 160), (256, 7, 320), (256, 7, 512),
                (3, 7, 2816), (5, 9, 37), (8, 14, 768)]


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("n,h,c", _PLAN_SHAPES)
def test_wgrad_plan_fits_the_card(n, h, c, elem_bytes):
    """The row-11 launch plan on an H100: a tile of whole strips (rows a
    multiple of 4, columns of 8) no larger than the map rounded up; shared
    memory what two staging buffers take and room for two blocks an SM; a
    chunk dividing C, 16-byte staging exactly where C and the chunk allow
    it; threads the chunk times at most one slot per strip, at most 256;
    workers (gridDim.x) within CUDA's limits, none without a unit, and one
    wave of them: no more than the card holds at once."""
    plan = dw.wgrad_plan(n, h, h, c, elem_bytes, H100_OPTIN, H100_SMS)
    assert plan.th % 4 == 0 and plan.tw % 8 == 0
    assert plan.th <= -(-h // 4) * 4 and plan.tw <= -(-h // 8) * 8
    sites = (plan.th + 6) * (plan.tw + 6) + plan.th * plan.tw
    assert plan.smem == max(2 * sites * plan.cc * elem_bytes, 49 * plan.cc * 4)
    assert 2 * (plan.smem + 1024) <= H100_OPTIN
    assert c % plan.cc == 0 and plan.cc <= 64
    assert plan.vec == (c * elem_bytes % 16 == 0 and plan.cc * elem_bytes % 16 == 0)
    strips = (plan.th // 4) * (plan.tw // 8)
    assert plan.threads % plan.cc == 0 and plan.threads <= 256
    assert 1 <= plan.threads // plan.cc <= strips
    units = n * -(-h // plan.th) * -(-h // plan.tw)
    assert 1 <= plan.workers <= min(units, 65535) and c // plan.cc <= 65535
    resident = min(H100_OPTIN // plan.smem, 65536 // (128 * plan.threads))
    assert plan.workers * (c // plan.cc) <= max(resident * H100_SMS, c // plan.cc)


def test_wgrad_plan_fills_the_card_on_the_main_paths():
    """At the finetune and masked-dense stage shapes in bf16 every launch
    gives the H100 at least two blocks an SM with one unit a block, and at
    least one block an SM as workers; a block's threads divide its tile's
    strips evenly (no slot walks one strip more than another)."""
    for n, h, c in _PLAN_SHAPES[:9]:
        plan = dw.wgrad_plan(n, h, h, c, 2, H100_OPTIN, H100_SMS)
        tiles = -(-h // plan.th) * -(-h // plan.tw)
        assert n * tiles * (c // plan.cc) >= 2 * H100_SMS
        assert plan.workers * (c // plan.cc) >= H100_SMS
        strips, slots = (plan.th // 4) * (plan.tw // 8), plan.threads // plan.cc
        assert strips % slots == 0, (n, h, c, plan)


@pytest.mark.parametrize("n,h,c", [(3, 9, 40), (2, 14, 37)])
def test_wgrad_tiles_cover_the_map(n, h, c):
    """The kernel's tiling done in numpy on the plan: each tile's (th+6) x
    (tw+6) halo with zeros outside the map and its dy tile with zeros beyond
    it, summed strip by strip, gives the plain weight gradient."""
    rng = np.random.default_rng(h + c)
    x = rng.normal(size=(n, h, h, c)).astype(np.float32)
    dy = rng.normal(size=(n, h, h, c)).astype(np.float32)
    plan = dw.wgrad_plan(n, h, h, c, 4, H100_OPTIN, H100_SMS)
    xp = np.zeros((n, h + plan.th + 6, h + plan.tw + 6, c), np.float32)
    xp[:, 3:3 + h, 3:3 + h] = x
    dyp = np.zeros((n, h + plan.th, h + plan.tw, c), np.float32)
    dyp[:, :h, :h] = dy
    got = np.zeros((c, 49), np.float64)
    for y0 in range(0, h, plan.th):
        for x0 in range(0, h, plan.tw):
            halo = xp[:, y0:y0 + plan.th + 6, x0:x0 + plan.tw + 6]
            dt = dyp[:, y0:y0 + plan.th, x0:x0 + plan.tw]
            for t in range(49):
                a, b = divmod(t, 7)
                got[:, t] += np.einsum("nyxc,nyxc->c", halo[:, a:a + plan.th, b:b + plan.tw],
                                       dt)
    ref = dw.dw_weight_grad_plain(torch.from_numpy(x), torch.from_numpy(dy))
    _close(got.reshape(c, 1, 7, 7), ref.numpy(), 1e-5, "tiled sums")

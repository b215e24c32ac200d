"""The port's spill-g block tail (``mmearth_tpu_torch.ops.fused_block``)
against the JAX package, on the CPU, where the port runs its plain version.

The same numpy inputs go through ``fused_block_mlp_spillg_reference`` (via
``jax.vjp``), through the Pallas kernel in interpret mode
(``fused_block_mlp_spillg(..., True)``), and through the port; the forward and
all 10 gradients are compared.  Tolerances, relative to each output's largest
magnitude: f32 1e-4 (only the summation order and the GELU's erf differ: the
Pallas kernel uses a polynomial with |error| <= 1.5e-7, the port torch.erf);
bf16 2e-2, as ``tests/test_fused_block.py`` holds the Pallas kernel.  The
CUDA kernels are held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mmearth_tpu.models.convnextv2 import gelu as jax_gelu
from mmearth_tpu.models.norm import LayerNorm as JaxLayerNorm
from mmearth_tpu.models.norm import MaskedGRN as JaxMaskedGRN
from mmearth_tpu.ops import fused_block as jfb
from mmearth_tpu_torch.models.norm import LayerNorm, MaskedGRN
from mmearth_tpu_torch.ops import fused_block as fb

ORDER = ("t", "x_res", "ln_scale", "ln_bias", "w1", "b1", "gamma", "beta", "w2", "b2")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _make(m, c, seed=0, dead_channel=None):
    """JAX-layout f32 numpy inputs (w1 (C, 4C), w2 (4C, C)) and a cotangent.
    ``dead_channel``: a hidden channel whose GELU output is exactly 0 on
    every row (so its GRN gx is 0)."""
    rng = np.random.default_rng(seed)
    c4 = 4 * c
    a = dict(
        t=rng.normal(size=(m, c)), x_res=rng.normal(size=(m, c)),
        ln_scale=rng.normal(1, 0.1, size=(c,)), ln_bias=rng.normal(0, 0.1, size=(c,)),
        w1=rng.normal(size=(c, c4)) * 0.1, b1=rng.normal(0, 0.1, size=(c4,)),
        gamma=rng.normal(0, 0.5, size=(c4,)), beta=rng.normal(0, 0.1, size=(c4,)),
        w2=rng.normal(size=(c4, c)) * 0.1, b2=rng.normal(0, 0.1, size=(c,)))
    if dead_channel is not None:
        a["w1"][:, dead_channel] = 0.0
        a["b1"][dead_channel] = -30.0  # gelu(-30) == 0 in f32
    a = {k: v.astype(np.float32) for k, v in a.items()}
    return a, rng.normal(size=(m, c)).astype(np.float32)


def _jax(a, dy, dtype, fn):
    args = [jnp.asarray(a[k], dtype if k in ("t", "x_res") else jnp.float32) for k in ORDER]
    y, vjp = jax.vjp(fn, *args)
    return [np.asarray(y, np.float32)] + [np.asarray(g, np.float32)
                                          for g in vjp(jnp.asarray(dy, dtype))]


def _port(a, dy, dtype, group_rows=None):
    """The port's forward and grads, returned in JAX's layout."""
    tdt = getattr(torch, dtype)
    c4 = a["w1"].shape[1]
    ts = {k: torch.from_numpy(a[k]) for k in ORDER}
    ts["t"], ts["x_res"] = ts["t"].to(tdt), ts["x_res"].to(tdt)
    ts["w1"], ts["w2"] = ts["w1"].t().contiguous(), ts["w2"].t().contiguous()
    ts["gamma"], ts["beta"] = ts["gamma"].reshape(1, 1, 1, c4), ts["beta"].reshape(1, 1, 1, c4)
    for v in ts.values():
        v.requires_grad_()
    y = fb.fused_block_mlp_spillg(*[ts[k] for k in ORDER], group_rows=group_rows)
    y.backward(torch.from_numpy(dy).to(tdt))
    grads = []
    for k in ORDER:
        g = ts[k].grad.float()
        grads.append((g.t() if k in ("w1", "w2") else g.reshape(a[k].shape)).numpy())
    return [y.detach().float().numpy()] + grads


def _assert_all_close(got, ref, tol):
    for name, g, r in zip(("y",) + ORDER, got, ref):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol * max(np.abs(r).max(), 1e-6),
                                   err_msg=name)


@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax(dtype, against):
    """700 rows (not a multiple of any tile): forward and all 10 gradients."""
    a, dy = _make(700, 16, seed=1)
    fn = (jfb.fused_block_mlp_spillg_reference if against == "reference"
          else lambda *xs: jfb.fused_block_mlp_spillg(*xs, True))
    got = _port(a, dy, dtype)
    _assert_all_close(got, _jax(a, dy, getattr(jnp, dtype), fn), TOL[dtype])
    # the composed plain forward is the forward the autograd function runs
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(a[k]) for k in ORDER]
    args[0], args[1] = args[0].to(tdt), args[1].to(tdt)
    args[4], args[8] = args[4].t(), args[8].t()
    np.testing.assert_array_equal(fb.fused_block_mlp_spillg_plain(*args).float().numpy(), got[0])


# (C, rows): the atto stages (C = 40/80/160/320 at p = 8/4/2/1) on one GRN
# group of 19 visible patches of p x p rows in each of N = 2 samples
_ATTO_STAGES = [(40, 19 * 64 * 2), (80, 19 * 16 * 2), (160, 19 * 4 * 2), (320, 19 * 2)]


@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("c,m", _ATTO_STAGES)
def test_plain_matches_jax_at_atto_widths(c, m, against):
    """The atto stage widths in f32: forward and all 10 gradients against the
    reference and the Pallas kernel (interpret mode), within 1e-4 of scale."""
    a, dy = _make(m, c, seed=c)
    fn = (jfb.fused_block_mlp_spillg_reference if against == "reference"
          else lambda *xs: jfb.fused_block_mlp_spillg(*xs, True))
    _assert_all_close(_port(a, dy, "float32"), _jax(a, dy, jnp.float32, fn), TOL["float32"])


def _pallas_specs(tm):
    """Row tiles of ``tm`` rows and whole-array blocks, as ``_sg_fwd`` cuts them."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    row = lambda cc: pl.BlockSpec((tm, cc), lambda i: (i, 0), memory_space=pltpu.VMEM)
    full = lambda shape: pl.BlockSpec(shape, lambda i: tuple(0 for _ in shape),
                                      memory_space=pltpu.VMEM)
    return row, full


def _phase_inputs(groups, gr=150, c=16):
    a, dy = _make(gr * groups, c, seed=5)
    ts = {k: torch.from_numpy(v) for k, v in a.items()}
    return a, dy, ts, ts["w1"].t(), ts["w2"].t()


@pytest.mark.parametrize("groups", [1, 2])
def test_phase_a_matches_the_pallas_kernel(groups):
    """Phase A (``fwd_a_plain``, the plain version of row 7's launch): g and
    the sum of g^2 of each GRN group in f32 against the Pallas kernel it
    replaces (``_sg_fwd_a_kernel``, interpret mode), which takes one group
    (all its rows): run once a group, its g stacked and its gx squared,
    within the file's f32 tolerance."""
    import functools

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    gr, c = 150, 16
    a, _, ts, w1, _ = _phase_inputs(groups, gr, c)
    c4 = 4 * c
    g, gxsq = fb.fwd_a_plain(ts["t"], ts["ln_scale"], ts["ln_bias"], w1, ts["b1"], gr)

    tm = jfb._sg_tile(c4)
    row, full = _pallas_specs(tm)
    ref_g, ref_sq = [], []
    for i in range(groups):
        tp = jfb._pad_rows(jnp.asarray(a["t"][i * gr:(i + 1) * gr]), tm)
        gp, gx = pl.pallas_call(
            functools.partial(jfb._sg_fwd_a_kernel, m_valid=gr), grid=(tp.shape[0] // tm,),
            in_specs=[row(c), full((1, c)), full((1, c)), full((c, c4)), full((1, c4))],
            out_specs=[row(c4), full((1, c4))],
            out_shape=[jax.ShapeDtypeStruct((tp.shape[0], c4), jnp.float32),
                       jax.ShapeDtypeStruct((1, c4), jnp.float32)],
            scratch_shapes=[pltpu.VMEM((1, c4), jnp.float32)],
            interpret=True,
        )(tp, jnp.asarray(a["ln_scale"]).reshape(1, c), jnp.asarray(a["ln_bias"]).reshape(1, c),
          jnp.asarray(a["w1"]), jnp.asarray(a["b1"]).reshape(1, c4))
        ref_g.append(np.asarray(gp)[:gr])
        ref_sq.append(np.asarray(gx) ** 2)
    for name, x, r in (("g", g, np.concatenate(ref_g)), ("gxsq", gxsq, np.concatenate(ref_sq))):
        np.testing.assert_allclose(x.numpy(), r, rtol=TOL["float32"],
                                   atol=TOL["float32"] * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("groups", [1, 2])
def test_phase_b_matches_the_pallas_kernel(groups):
    """Phase B (``fwd_b_plain``, the plain version of row 8's launch): y of
    each GRN group in f32, given the same g and the group's gx (``gxsq`` the
    port's, its square root the kernel's), against the Pallas kernel it
    replaces (``_sg_fwd_b_kernel``, interpret mode), run once a group, within
    the file's f32 tolerance."""
    from jax.experimental import pallas as pl

    gr, c = 150, 16
    a, _, ts, w1, w2 = _phase_inputs(groups, gr, c)
    c4 = 4 * c
    g, gxsq = fb.fwd_a_plain(ts["t"], ts["ln_scale"], ts["ln_bias"], w1, ts["b1"], gr)
    y, gx, _ = fb.fwd_b_plain(g, ts["x_res"], gxsq, ts["gamma"], ts["beta"], w2, ts["b2"], gr)

    tm = jfb._sg_tile(c4)
    row, full = _pallas_specs(tm)
    vec = lambda k, n: jnp.asarray(a[k]).reshape(1, n)
    ref = []
    for i in range(groups):
        rows = slice(i * gr, (i + 1) * gr)
        gp = jfb._pad_rows(jnp.asarray(g[rows].numpy()), tm)
        xp = jfb._pad_rows(jnp.asarray(a["x_res"][rows]), tm)
        yp = pl.pallas_call(
            jfb._sg_fwd_b_kernel, grid=(gp.shape[0] // tm,),
            in_specs=[row(c4), row(c), full((1, c4)), full((1, c4)), full((1, c4)),
                      full((c4, c)), full((1, c))],
            out_specs=row(c),
            out_shape=jax.ShapeDtypeStruct((gp.shape[0], c), jnp.float32),
            interpret=True,
        )(gp, xp, jnp.asarray(gx[i:i + 1].numpy()), vec("gamma", c4), vec("beta", c4),
          jnp.asarray(a["w2"]), vec("b2", c))
        ref.append(np.asarray(yp)[:gr])
    r = np.concatenate(ref)
    np.testing.assert_allclose(y.numpy(), r, rtol=TOL["float32"],
                               atol=TOL["float32"] * np.abs(r).max(), err_msg="y")


@pytest.mark.parametrize("groups", [1, 2])
def test_phase_c_matches_the_pallas_kernel(groups):
    """Phase C with dW2 folded in (``bwd_c_plain``, the plain version of the
    one launch): db2, dgamma, dbeta, dnx and dW2 in f32 against the Pallas
    kernel it replaces (``_sg_bwd_c_kernel``, interpret mode), which sums
    over all its rows: run once a GRN group, its dnx stacked and the rest
    added, within the file's f32 tolerance."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    gr, c = 150, 16
    m, c4 = gr * groups, 4 * c
    a, dy_np = _make(m, c, seed=4)
    ts = {k: torch.from_numpy(v) for k, v in a.items()}
    w1, w2, dy = ts["w1"].t(), ts["w2"].t(), torch.from_numpy(dy_np)
    g, gxsq = fb.fwd_a_plain(ts["t"], ts["ln_scale"], ts["ln_bias"], w1, ts["b1"], gr)
    _, gx, nx = fb.fwd_b_plain(g, ts["x_res"], gxsq, ts["gamma"], ts["beta"], w2, ts["b2"], gr)
    got = fb.bwd_c_plain(dy, g, nx, ts["gamma"], ts["beta"],
                         fb.bwd_weights_plain(w1, w2, torch.float32), gr)

    tm = jfb._sg_tile(c4)
    row = lambda cc: pl.BlockSpec((tm, cc), lambda i: (i, 0), memory_space=pltpu.VMEM)
    full = lambda shape: pl.BlockSpec(shape, lambda i: tuple(0 for _ in shape),
                                      memory_space=pltpu.VMEM)
    vec = lambda k: jnp.asarray(a[k]).reshape(1, c4)
    parts = []
    for i in range(groups):
        rows = slice(i * gr, (i + 1) * gr)
        dyp = jfb._pad_rows(jnp.asarray(dy_np[rows]), tm)
        gp = jfb._pad_rows(jnp.asarray(g[rows].numpy()), tm)
        parts.append(pl.pallas_call(
            jfb._sg_bwd_c_kernel, grid=(dyp.shape[0] // tm,),
            in_specs=[row(c), row(c4), full((1, c4)), full((1, c4)), full((1, c4)),
                      full((c4, c))],
            out_specs=[full((c4, c)), full((1, c)), full((1, c4)), full((1, c4)),
                       full((1, c4))],
            out_shape=[jax.ShapeDtypeStruct((c4, c), jnp.float32)]
            + [jax.ShapeDtypeStruct((1, n), jnp.float32) for n in (c, c4, c4, c4)],
            scratch_shapes=[pltpu.VMEM((c4, c), jnp.float32)]
            + [pltpu.VMEM((1, n), jnp.float32) for n in (c, c4, c4, c4)],
            interpret=True,
        )(dyp, gp, jnp.asarray(gx[i:i + 1].numpy()), vec("gamma"), vec("beta"),
          jnp.asarray(a["w2"])))
    dw2, db2, dgamma, dbeta = (sum(np.asarray(p[j]) for p in parts) for j in range(4))
    dnx = np.concatenate([np.asarray(p[4]) for p in parts])
    ref = (db2.reshape(c), dgamma.reshape(c4), dbeta.reshape(c4), dnx, dw2.T)
    for name, x, r in zip(("db2", "dgamma", "dbeta", "dnx", "dW2"), got, ref):
        np.testing.assert_allclose(x.numpy(), r, rtol=TOL["float32"],
                                   atol=TOL["float32"] * np.abs(r).max(), err_msg=name)


def test_dead_channel_has_finite_grads():
    """A hidden channel with gx == 0: dgx/gx is taken as 0 there
    (``fused_block.py:606``), so no gradient is NaN; against the Pallas
    kernel, whose guard is the same (the reference's sqrt has no subgradient
    at 0 and gives NaN)."""
    a, dy = _make(320, 8, seed=2, dead_channel=5)
    ref = _jax(a, dy, jnp.float32, lambda *xs: jfb.fused_block_mlp_spillg(*xs, True))
    _assert_all_close(_port(a, dy, "float32"), ref, TOL["float32"])


class _JaxTail(fnn.Module):
    """The JAX package's XLA tail of a gathered Block
    (``convnextv2.py:499-504``) on (N, S, C) rows: MaskedGRN over groups of
    ``group`` samples."""
    dim: int
    group: int

    @fnn.compact
    def __call__(self, t, x):
        u = JaxLayerNorm(self.dim, name="norm")(t)
        u = jax_gelu(fnn.Dense(4 * self.dim, name="pwconv1")(u), False)
        u = JaxMaskedGRN(4 * self.dim, group=self.group, name="grn")(
            u, jnp.ones(t.shape[:-1] + (1,), t.dtype))
        return x + fnn.Dense(self.dim, name="pwconv2")(u)


def test_grouped_grn_matches_masked_grn():
    """Two GRN groups (N = 4 samples of 50 rows, group = 2 samples): the port
    against the JAX XLA tail with MaskedGRN(group) and against the port's own
    composed tail (LN -> Linear -> GELU -> MaskedGRN(group) -> Linear +
    residual), f32, forward and every gradient within 1e-4 of scale."""
    n, s, c, group = 4, 50, 16, 2
    a, dy = _make(n * s, c, seed=3)
    params = {"norm": {"scale": a["ln_scale"], "bias": a["ln_bias"]},
              "pwconv1": {"kernel": a["w1"], "bias": a["b1"]},
              "grn": {"gamma": a["gamma"], "beta": a["beta"]},
              "pwconv2": {"kernel": a["w2"], "bias": a["b2"]}}
    tail = _JaxTail(c, group)

    def jax_fn(p, t, x):
        return tail.apply({"params": p}, t.reshape(n, s, c), x.reshape(n, s, c)).reshape(n * s, c)

    y, vjp = jax.vjp(jax_fn, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(a["t"]),
                     jnp.asarray(a["x_res"]))
    gp, gt, gx = vjp(jnp.asarray(dy))
    ref = [y, gt, gx, gp["norm"]["scale"], gp["norm"]["bias"], gp["pwconv1"]["kernel"],
           gp["pwconv1"]["bias"], gp["grn"]["gamma"], gp["grn"]["beta"], gp["pwconv2"]["kernel"],
           gp["pwconv2"]["bias"]]
    got = _port(a, dy, "float32", group_rows=group * s)
    _assert_all_close(got, [np.asarray(r, np.float32) for r in ref], TOL["float32"])

    # the port's composed tail with the same params
    norm, grn = LayerNorm(c), MaskedGRN(4 * c, group=group)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(a["ln_scale"]))
        norm.bias.copy_(torch.from_numpy(a["ln_bias"]))
        grn.gamma.copy_(torch.from_numpy(a["gamma"]).reshape(grn.gamma.shape))
        grn.beta.copy_(torch.from_numpy(a["beta"]).reshape(grn.beta.shape))
    t = torch.from_numpy(a["t"]).reshape(n, s, c).requires_grad_()
    u = F.gelu(F.linear(norm(t), torch.from_numpy(a["w1"]).t(), torch.from_numpy(a["b1"])))
    yc = torch.from_numpy(a["x_res"]).reshape(n, s, c) + F.linear(
        grn(u), torch.from_numpy(a["w2"]).t(), torch.from_numpy(a["b2"]))
    yc.backward(torch.from_numpy(dy).reshape(n, s, c))
    for name, g, r in (("y", got[0], yc.detach().reshape(n * s, c)),
                       ("t", got[1], t.grad.reshape(n * s, c)),
                       ("ln_scale", got[3], norm.weight.grad),
                       ("gamma", got[7], grn.gamma.grad.reshape(-1))):
        r = r.numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_group_rows_must_divide_the_rows():
    a, _ = _make(100, 8)
    args = [torch.from_numpy(a[k]) for k in ORDER]
    with pytest.raises(ValueError, match="must divide"):
        fb.fused_block_mlp_spillg(*args, group_rows=30)


def test_only_cpu_tensors_take_the_plain_path():
    """Only a CPU tensor takes the plain version; any other device goes to the
    kernel (CUDA) or raises, checked here with the meta device."""
    c = 8
    assert fb.phases(torch.empty(64, c)) is fb.PLAIN
    assert fb.PLAIN != fb.CUDA and all(p is not k for p, k in zip(fb.PLAIN, fb.CUDA))
    t = torch.empty(64, c, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.phases(t)
    args = (torch.empty(c), torch.empty(c), torch.empty(4 * c, c), torch.empty(4 * c),
            torch.empty(1, 1, 1, 4 * c), torch.empty(1, 1, 1, 4 * c), torch.empty(c, 4 * c),
            torch.empty(c))
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.fused_block_mlp_spillg(t, t, *args)


@pytest.mark.parametrize("group,n,expect", [(0, 8, 8), (4, 8, 4), (16, 8, 8), (3, 8, 8)])
def test_spillg_tail_groups_rows_as_masked_grn(group, n, expect, monkeypatch):
    """The spill-g tail takes its GRN group from ``MaskedGRN.group_size``, the
    rule the composed tail applies: ``group`` samples, or the whole batch when
    it is 0 or does not divide the batch (which warns)."""
    from mmearth_tpu_torch.models import convnextv2

    blk = convnextv2.Block(8, sparse=True, grn_group=group, spillg=True)
    warns = group > 0 and n % group
    seen = []
    monkeypatch.setattr(convnextv2, "fused_block_mlp_spillg",
                        lambda t, x, *params, group_rows: seen.append(group_rows) or x)
    x = torch.zeros(n, 2, 2, 2, 8)
    with pytest.warns(UserWarning, match="not divisible") if warns else contextlib.nullcontext():
        assert blk.grn.group_size(n) == expect
        blk._spillg_tail(x, x)
    assert seen == [expect * 2 * 2 * 2]

"""The port's masked-dense block tail (``mmearth_tpu_torch.ops.fused_block.
fused_block_mlp``) against the JAX package, on the CPU, where the port runs its
plain version.

The same numpy inputs, with a random keep mask, go through
``fused_block_mlp_reference`` (via ``jax.vjp``), through the Pallas kernel in
interpret mode (``fused_block_mlp(..., True)``, as ``tests/test_fused_block.py``
runs it), and through the port; the forward and all 10 gradients are
compared (``keep`` takes none).  Tolerances, relative to each output's largest
magnitude: f32 1e-4 (only the summation order and the GELU's erf differ: the
Pallas kernel uses a polynomial with |error| <= 1.5e-7, the port torch.erf);
bf16 2e-2, as ``tests/test_fused_block.py`` holds the Pallas kernel.  The
CUDA kernels are held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""
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

ORDER = ("t", "x_res", "keep", "ln_scale", "ln_bias", "w1", "b1", "gamma", "beta", "w2", "b2")
GRADS = tuple(k for k in ORDER if k != "keep")
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _make(m, c, seed=0, dead_channel=None):
    """JAX-layout f32 numpy inputs (w1 (C, 4C), w2 (4C, C)), keep (M, 1) with
    about 40% of the rows visible, and a cotangent.  ``dead_channel``: a
    hidden channel whose GELU output is exactly 0 on every row."""
    rng = np.random.default_rng(seed)
    c4 = 4 * c
    a = dict(
        t=rng.normal(size=(m, c)), x_res=rng.normal(size=(m, c)),
        keep=(rng.random((m, 1)) > 0.6),
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
    """y and the 10 gradients (no keep gradient) of ``fn`` in JAX."""
    args = [jnp.asarray(a[k], dtype if k in ("t", "x_res", "keep") else jnp.float32)
            for k in ORDER]
    y, vjp = jax.vjp(fn, *args)
    grads = vjp(jnp.asarray(dy, dtype))
    return [np.asarray(y, np.float32)] + [np.asarray(g, np.float32)
                                          for k, g in zip(ORDER, grads) if k != "keep"]


def _tensors(a, dtype):
    """The port's inputs: its param layout, activations (and keep) in ``dtype``."""
    tdt = getattr(torch, dtype)
    c4 = a["w1"].shape[1]
    ts = {k: torch.from_numpy(a[k]) for k in ORDER}
    for k in ("t", "x_res", "keep"):
        ts[k] = ts[k].to(tdt)
    ts["w1"], ts["w2"] = ts["w1"].t().contiguous(), ts["w2"].t().contiguous()
    ts["gamma"], ts["beta"] = ts["gamma"].reshape(1, 1, 1, c4), ts["beta"].reshape(1, 1, 1, c4)
    return ts


def _port(a, dy, dtype, group_rows=None):
    """The port's forward and grads, returned in JAX's layout."""
    ts = _tensors(a, dtype)
    for k in GRADS:
        ts[k].requires_grad_()
    y = fb.fused_block_mlp(*[ts[k] for k in ORDER], group_rows=group_rows)
    y.backward(torch.from_numpy(dy).to(ts["t"].dtype))
    grads = []
    for k in GRADS:
        g = ts[k].grad.float()
        grads.append((g.t() if k in ("w1", "w2") else g.reshape(a[k].shape)).numpy())
    return [y.detach().float().numpy()] + grads


def _assert_all_close(got, ref, tol):
    for name, g, r in zip(("y",) + GRADS, got, ref):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol * max(np.abs(r).max(), 1e-6),
                                   err_msg=name)


@pytest.mark.parametrize("against", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax(dtype, against):
    """700 rows (not a multiple of any tile): forward and all 10 gradients."""
    a, dy = _make(700, 16, seed=1)
    fn = (jfb.fused_block_mlp_reference if against == "reference"
          else lambda *xs: jfb.fused_block_mlp(*xs, True))
    got = _port(a, dy, dtype)
    _assert_all_close(got, _jax(a, dy, getattr(jnp, dtype), fn), TOL[dtype])
    # the composed plain forward is the forward the autograd function runs
    ts = _tensors(a, dtype)
    np.testing.assert_array_equal(
        fb.fused_block_mlp_plain(*[ts[k] for k in ORDER]).float().numpy(), got[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_rows_untouched(dtype):
    """At keep = 0 the output is x_res exactly and dt is exactly 0
    (``tests/test_fused_block.py:70`` pins the first for the Pallas kernel),
    and what t and dy hold there changes no gradient."""
    a, dy = _make(512, 24, seed=3)
    masked = a["keep"][:, 0] == 0
    got = _port(a, dy, dtype)
    x_res = torch.from_numpy(a["x_res"]).to(getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(got[0][masked], x_res[masked])
    assert not got[1][masked].any()
    b, dy2 = dict(a), dy.copy()
    rng = np.random.default_rng(4)
    b["t"] = np.where(masked[:, None], rng.normal(size=a["t"].shape), a["t"]).astype(np.float32)
    dy2[masked] = rng.normal(size=dy2[masked].shape)
    other = _port(b, dy2, dtype)
    for name, g, r in zip(("y",) + GRADS, other, got):
        if name not in ("y", "x_res"):  # d x_res = dy at every row
            np.testing.assert_array_equal(g, r, err_msg=name)


def test_dead_channel_has_finite_grads():
    """A hidden channel with gx == 0: dgx/gx is taken as 0 there
    (``fused_block.py:187``), so no gradient is NaN; against the Pallas
    kernel, whose guard is the same (the reference's sqrt has no subgradient
    at 0 and gives NaN)."""
    a, dy = _make(320, 8, seed=2, dead_channel=5)
    ref = _jax(a, dy, jnp.float32, lambda *xs: jfb.fused_block_mlp(*xs, True))
    _assert_all_close(_port(a, dy, "float32"), ref, TOL["float32"])


class _JaxMaskedTail(fnn.Module):
    """The JAX package's composed masked-dense tail of a Block
    (``convnextv2.py:532-543``) on (N, S, C) sites: MaskedGRN over groups of
    ``group`` samples, the tail re-masked before the residual."""
    dim: int
    group: int

    @fnn.compact
    def __call__(self, t, x, keep):
        u = JaxLayerNorm(self.dim, name="norm")(t)
        u = jax_gelu(fnn.Dense(4 * self.dim, name="pwconv1")(u), False)
        u = JaxMaskedGRN(4 * self.dim, group=self.group, name="grn")(u, keep)
        return x + fnn.Dense(self.dim, name="pwconv2")(u) * keep


def test_grouped_grn_matches_masked_grn():
    """Two GRN groups (N = 4 samples of 50 sites, group = 2 samples): the port
    against the JAX composed tail with MaskedGRN(group) and against the
    port's own composed tail (LN -> Linear -> GELU -> MaskedGRN(group, keep)
    -> Linear -> * keep + residual), f32, forward and every gradient within
    1e-4 of scale."""
    n, s, c, group = 4, 50, 16, 2
    a, dy = _make(n * s, c, seed=5)
    params = {"norm": {"scale": a["ln_scale"], "bias": a["ln_bias"]},
              "pwconv1": {"kernel": a["w1"], "bias": a["b1"]},
              "grn": {"gamma": a["gamma"], "beta": a["beta"]},
              "pwconv2": {"kernel": a["w2"], "bias": a["b2"]}}
    tail = _JaxMaskedTail(c, group)
    keep3 = jnp.asarray(a["keep"].reshape(n, s, 1))

    def jax_fn(p, t, x):
        return tail.apply({"params": p}, t.reshape(n, s, c), x.reshape(n, s, c),
                          keep3).reshape(n * s, c)

    y, vjp = jax.vjp(jax_fn, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(a["t"]),
                     jnp.asarray(a["x_res"]))
    gp, gt, gx = vjp(jnp.asarray(dy))
    ref = [y, gt, gx, gp["norm"]["scale"], gp["norm"]["bias"], gp["pwconv1"]["kernel"],
           gp["pwconv1"]["bias"], gp["grn"]["gamma"], gp["grn"]["beta"], gp["pwconv2"]["kernel"],
           gp["pwconv2"]["bias"]]
    got = _port(a, dy, "float32", group_rows=group * s)
    _assert_all_close(got, [np.asarray(r, np.float32) for r in ref], TOL["float32"])

    # the port's composed masked tail with the same params
    norm, grn = LayerNorm(c), MaskedGRN(4 * c, group=group)
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(a["ln_scale"]))
        norm.bias.copy_(torch.from_numpy(a["ln_bias"]))
        grn.gamma.copy_(torch.from_numpy(a["gamma"]).reshape(grn.gamma.shape))
        grn.beta.copy_(torch.from_numpy(a["beta"]).reshape(grn.beta.shape))
    keep = torch.from_numpy(a["keep"]).reshape(n, s, 1)
    t = torch.from_numpy(a["t"]).reshape(n, s, c).requires_grad_()
    u = F.gelu(F.linear(norm(t), torch.from_numpy(a["w1"]).t(), torch.from_numpy(a["b1"])))
    yc = torch.from_numpy(a["x_res"]).reshape(n, s, c) + F.linear(
        grn(u, keep), torch.from_numpy(a["w2"]).t(), torch.from_numpy(a["b2"])) * keep
    yc.backward(torch.from_numpy(dy).reshape(n, s, c))
    for name, g, r in (("y", got[0], yc.detach().reshape(n * s, c)),
                       ("t", got[1], t.grad.reshape(n * s, c)),
                       ("ln_scale", got[3], norm.weight.grad),
                       ("gamma", got[7], grn.gamma.grad.reshape(-1))):
        r = r.numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_group_rows_must_divide_the_rows():
    a, _ = _make(100, 8)
    ts = _tensors(a, "float32")
    with pytest.raises(ValueError, match="must divide"):
        fb.fused_block_mlp(*[ts[k] for k in ORDER], group_rows=30)


def test_only_cpu_tensors_take_the_plain_path():
    """Only a CPU tensor takes the plain version; any other device goes to the
    kernels (CUDA) or raises, checked here with the meta device."""
    c = 8
    assert fb.phases(torch.empty(64, c), masked=True) is fb.MASKED_PLAIN
    assert all(p is not k for p, k in zip(fb.MASKED_PLAIN, fb.MASKED_CUDA))
    t = torch.empty(64, c, device="meta")
    with pytest.raises(RuntimeError, match="fused_block_mlp: no kernel"):
        fb.phases(t, masked=True)
    args = (torch.empty(64, 1, device="meta"), torch.empty(c), torch.empty(c),
            torch.empty(4 * c, c), torch.empty(4 * c), torch.empty(1, 1, 1, 4 * c),
            torch.empty(1, 1, 1, 4 * c), torch.empty(c, 4 * c), torch.empty(c))
    with pytest.raises(RuntimeError, match="no kernel"):
        fb.fused_block_mlp(t, t, *args)

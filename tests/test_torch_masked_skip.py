"""The masked-dense tail computes kept rows only (``mmearth_tpu_torch.ops.
fused_block``): on the CPU, where the port runs its plain version.

(a) The kept-row list (``kept_rows_plain``, the plain version of the
``masked_rows`` kernel) against a numpy construction: each GRN group cut into
chunks of ``ROWS_CHUNK`` rows, each chunk's kept rows ascending then its
masked ones, and the count kept per chunk; for the pretraining mask (19 of 49
patches, upsampled to each atto stage), one visible patch, no masked patch,
every row masked, and two GRN groups with different counts.

(b) The plain phases on the compacted rows, scattered back (what the port
runs), against the same phases on every row (``masked_*_dense``, the Pallas
kernel's dense grid) and against JAX's ``fused_block_mlp`` (its reference
and the Pallas kernel in interpret mode, as ``tests/test_torch_masked_block.
py`` runs them): y, dt and every parameter gradient in f32 within 1e-4 of
each output's largest magnitude (the tolerance of that file: summation order
and the GELU's erf); y = x and dt = 0 bit-exactly at masked rows."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.ops import fused_block as jfb
from mmearth_tpu_torch.models.convnextv2 import upsample_mask
from mmearth_tpu_torch.ops import fused_block as fb

GRID = 7
TOL = 1e-4


def _patch_mask(n, visible, seed):
    """(n, 49) keep per patch with ``visible`` patches kept in each sample."""
    order = np.argsort(np.random.default_rng(seed).random((n, GRID * GRID)), axis=1)
    return (order < visible).astype(np.float32)


def _site_keep(patch_keep, side):
    """The patch keep upsampled to a ``side`` x ``side`` grid, (N * side^2, 1)."""
    up = upsample_mask(torch.from_numpy(patch_keep), GRID, side)
    return up.reshape(-1, 1).float()


# (name, keep (M, 1), rows a GRN group): N = 2 samples at each atto stage
# (56 x 56 gives groups of two 4096-row chunks), and the other patterns
_MASKS = {
    "pretrain_s0": lambda: (_site_keep(_patch_mask(2, 19, 0), 56), 2 * 56 * 56),
    "pretrain_s1": lambda: (_site_keep(_patch_mask(2, 19, 1), 28), 2 * 28 * 28),
    "pretrain_s2": lambda: (_site_keep(_patch_mask(2, 19, 2), 14), 2 * 14 * 14),
    "pretrain_s3": lambda: (_site_keep(_patch_mask(2, 19, 3), 7), 2 * 7 * 7),
    "one_visible": lambda: (_site_keep(_patch_mask(2, 1, 4), 14), 2 * 14 * 14),
    "none_masked": lambda: (_site_keep(_patch_mask(2, 49, 5), 14), 2 * 14 * 14),
    "all_masked": lambda: (_site_keep(_patch_mask(2, 0, 6), 14), 2 * 14 * 14),
    # two groups of one sample each, 19 and 5 patches visible
    "two_groups": lambda: (_site_keep(np.concatenate([_patch_mask(1, 19, 7),
                                                      _patch_mask(1, 5, 8)]), 14), 14 * 14),
}


def _numpy_list(keep, group_rows):
    """The kept-row list built row by row in numpy."""
    k = keep.reshape(-1).numpy() != 0
    ids, cnt = [], []
    for g0 in range(0, k.size, group_rows):
        for c0 in range(g0, g0 + group_rows, fb.ROWS_CHUNK):
            rows = np.arange(c0, min(c0 + fb.ROWS_CHUNK, g0 + group_rows))
            ids += list(rows[k[rows]]) + list(rows[~k[rows]])
            cnt.append(int(k[rows].sum()))
    return np.array(ids, np.int32), np.array(cnt, np.int32)


@pytest.mark.parametrize("mask", list(_MASKS))
def test_kept_row_list_matches_numpy(mask):
    keep, gr = _MASKS[mask]()
    rows = fb.kept_rows_plain(keep, gr)
    ids, cnt = _numpy_list(keep, gr)
    assert rows.ids.dtype == rows.cnt.dtype == torch.int32
    np.testing.assert_array_equal(rows.ids.numpy(), ids)
    np.testing.assert_array_equal(rows.cnt.numpy(), cnt)
    slots = fb.kept_slots(rows, gr)
    assert int(slots.sum()) == int((keep != 0).sum())
    np.testing.assert_array_equal(np.sort(rows.ids[slots].numpy()),
                                  np.flatnonzero(keep.reshape(-1).numpy()))


def _inputs(m, c, seed):
    """JAX-layout f32 numpy params (w1 (C, 4C), w2 (4C, C)), rows and a cotangent."""
    rng = np.random.default_rng(seed)
    c4 = 4 * c
    a = dict(t=rng.normal(size=(m, c)), x_res=rng.normal(size=(m, c)),
             ln_scale=rng.normal(1, 0.1, size=(c,)), ln_bias=rng.normal(0, 0.1, size=(c,)),
             w1=rng.normal(size=(c, c4)) * 0.1, b1=rng.normal(0, 0.1, size=(c4,)),
             gamma=rng.normal(0, 0.5, size=(c4,)), beta=rng.normal(0, 0.1, size=(c4,)),
             w2=rng.normal(size=(c4, c)) * 0.1, b2=rng.normal(0, 0.1, size=(c,)),
             dy=rng.normal(size=(m, c)))
    return {k: v.astype(np.float32) for k, v in a.items()}


PARAMS = ("ln_scale", "ln_bias", "w1", "b1", "gamma", "beta", "w2", "b2")


def _port_params(a):
    """The params in the port's layout (torch.nn.Linear weights, flat GRN affines)."""
    p = {k: torch.from_numpy(a[k]) for k in PARAMS}
    p["w1"], p["w2"] = p["w1"].t().contiguous(), p["w2"].t().contiguous()
    return p


def _phases_grads(a, keep, gr, dense):
    """y, dt and the 8 param grads (JAX layout) of the plain phases, on the
    kept rows (what the port runs) or on every row (``dense``)."""
    p = _port_params(a)
    t, x, dy = (torch.from_numpy(a[k]) for k in ("t", "x_res", "dy"))
    lw, lb, w1, b1, gm, bt, w2, b2 = (p[k] for k in PARAMS)
    if dense:
        gxsq = fb.masked_fwd_stat_dense(t, keep, lw, lb, w1, b1, gr)
        y, gx, nx = fb.masked_fwd_apply_dense(t, x, keep, gxsq, lw, lb, w1, b1, gm, bt, w2, b2,
                                              gr)
        db2, dgm, dbt, dnx, do, h = fb.masked_bwd_stat_dense(t, dy, keep, nx, lw, lb, w1, b1, gm,
                                                              bt, w2, gr)
        dw2 = fb.atb_plain(do, h)
        dt, db1, dlnw, dlnb, dv, u = fb.masked_bwd_dv_dense(
            t, do, keep, nx, fb.dgx_step(dnx, gx), lw, lb, w1, b1, gm, w2, gr)
        dw1 = fb.atb_plain(dv, u)
    else:
        rows = fb.kept_rows_plain(keep, gr)
        gxsq = fb.masked_fwd_stat_plain(t, keep, rows, lw, lb, w1, b1, gr)
        y, gx, nx = fb.masked_fwd_apply_plain(t, x, keep, rows, gxsq, lw, lb, w1, b1, gm, bt,
                                              w2, b2, gr)
        db2, dgm, dbt, dnx, do, h = fb.masked_bwd_stat_plain(t, dy, keep, rows, nx, lw, lb, w1,
                                                              b1, gm, bt, w2, gr)
        dw2 = fb.masked_atb_plain(do, h, rows, gr)
        dt, db1, dlnw, dlnb, dv, u = fb.masked_bwd_dv_plain(
            t, do, keep, rows, nx, fb.dgx_step(dnx, gx), lw, lb, w1, b1, gm, w2, gr)
        dw1 = fb.masked_atb_plain(dv, u, rows, gr)
    grads = (dlnw, dlnb, dw1.t(), db1, dgm, dbt, dw2.t(), db2)
    return [y.numpy(), dt.numpy()] + [g.numpy() for g in grads]


def _jax_grads(a, keep, against):
    """y, dt and the 8 param grads of JAX's fused_block_mlp (one GRN group)."""
    fn = (jfb.fused_block_mlp_reference if against == "reference"
          else lambda *xs: jfb.fused_block_mlp(*xs, True))
    order = ("t", "x_res", "keep") + PARAMS
    vals = {**a, "keep": keep.numpy()}
    y, vjp = jax.vjp(fn, *[jnp.asarray(vals[k]) for k in order])
    g = dict(zip(order, vjp(jnp.asarray(a["dy"]))))
    return [np.asarray(y), np.asarray(g["t"])] + [np.asarray(g[k]) for k in PARAMS]


NAMES = ("y", "dt") + PARAMS


def _close(got, ref, what):
    for name, g, r in zip(NAMES, got, ref):
        assert np.isfinite(g).all(), (what, name)
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL * max(np.abs(r).max(), 1e-6),
                                   err_msg=f"{what}: {name}")


@pytest.mark.parametrize("mask", list(_MASKS))
def test_compacted_phases_match_dense_phases(mask):
    """The phases on the kept rows, scattered back, against the same phases
    on every row, at each mask of ``_MASKS`` (C = 8); y = x and dt = 0
    exactly at masked rows."""
    keep, gr = _MASKS[mask]()
    a = _inputs(keep.shape[0], 8, seed=len(mask))
    got = _phases_grads(a, keep, gr, dense=False)
    _close(got, _phases_grads(a, keep, gr, dense=True), "dense phases")
    masked = keep[:, 0].numpy() == 0
    np.testing.assert_array_equal(got[0][masked], a["x_res"][masked])
    assert not got[1][masked].any()


# every row masked leaves gx = 0 in every channel, where the reference's sqrt
# has no subgradient (NaN, ``test_dead_channel_has_finite_grads``): that mask
# is held against the Pallas kernel, whose guard is the port's
_JAX_CASES = [(mask, against) for mask in ("pretrain_s2", "pretrain_s3", "one_visible",
                                           "none_masked", "all_masked")
              for against in ("reference", "pallas_interpret")
              if (mask, against) != ("all_masked", "reference")]


@pytest.mark.parametrize("mask,against", _JAX_CASES)
def test_compacted_phases_match_jax(mask, against):
    """The phases on the kept rows, scattered back, against JAX's
    ``fused_block_mlp`` (one GRN group of every row, C = 16)."""
    keep, _ = _MASKS[mask]()
    m = keep.shape[0]
    a = _inputs(m, 16, seed=m)
    got = _phases_grads(a, keep, m, dense=False)
    _close(got, _jax_grads(a, keep, against), f"JAX {against}")
    masked = keep[:, 0].numpy() == 0
    np.testing.assert_array_equal(got[0][masked], a["x_res"][masked])
    assert not got[1][masked].any()

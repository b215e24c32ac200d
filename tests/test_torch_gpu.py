"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``gpu`` and skipped without a card; this file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch and nvcc:

    python -m pytest tests/test_torch_gpu.py -m gpu
"""
import numpy as np
import pytest
import torch

from mmearth_tpu_torch.models.convnextv2 import visible_ids
from mmearth_tpu_torch.ops import fused_block as fb
from mmearth_tpu_torch.ops import patch_select as ps
from mmearth_tpu_torch.ops import wholeblock as wb

GRID, K = 7, 19


@pytest.mark.gpu
def test_kernels_match_plain_on_gpu():
    """The dwconv7_gathered kernels against their plain versions at the atto
    stages (needs a GPU and nvcc); the patch kernels' inputs come from the
    plain gather."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    order = np.argsort(np.random.default_rng(1).random((8, GRID * GRID)), axis=1)
    mask = torch.from_numpy((order >= K).astype(np.float32)).to(dev)
    kept, inv = visible_ids(mask, K)
    for p, c in ((8, 40), (4, 80), (2, 160), (1, 320)):
        h = GRID * p
        x = torch.randn(8, h, h, c, device=dev, dtype=torch.bfloat16)
        xg = ps.gather_patches_plain(x, kept, p, GRID)
        w, b = torch.randn(c, 1, 7, 7, device=dev), torch.randn(c, device=dev)
        ref = wb.dwconv7_gathered_plain(xg, kept, w, b, GRID).float()
        got = wb._fwd_cuda(xg, kept, inv, w, b, GRID).float()
        assert float((got - ref).abs().max()) <= 2 ** -6 * float(ref.abs().max())
        dx, dk, db = wb._bwd_cuda(xg, xg, kept, inv, w, GRID)
        rdx, rdk, rdb = wb.dwconv7_gathered_bwd_plain(xg, xg, kept, w, GRID)
        assert float((dx.float() - rdx.float()).abs().max()) <= 2 ** -6 * float(rdx.abs().max())
        torch.testing.assert_close(dk, rdk, rtol=1e-3, atol=1e-3 * float(rdk.abs().max()))
        torch.testing.assert_close(db, rdb, rtol=1e-3, atol=1e-3 * float(rdb.abs().max()))


# (p, C): the atto stages, pico-112/16's stem and stage 3, huge's last width,
# and C = 37 and 24 (rows of 74 and 48 bytes at p = 1: the register path in
# bf16 where the row is not a multiple of 16 bytes)
_PATCH_CASES = [(8, 40), (4, 80), (2, 160), (1, 320), (16, 64), (2, 512), (8, 37), (1, 37),
                (2, 37), (1, 24), (1, 2816)]
# (grid, K): one visible patch, the pretraining mask, every patch, a 14-patch grid
_PATCH_MASKS = [(7, 1), (7, 19), (7, 49), (14, 77)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("p,c", _PATCH_CASES)
def test_gather_scatter_match_plain_on_gpu(dtype, p, c):
    """Gather and scatter bit-exact against the plain versions at odd N = 3
    for each mask of ``_PATCH_MASKS``, one launch each; the path the plan
    takes follows its rule (bulk copies where the row is a multiple of 16
    bytes and both pointers are 16-byte aligned); views whose base lies one
    or two elements into their buffer take the register path (2-, 4- or
    8-byte vectors as the row and the offset allow) and agree too; the
    gather -> scatter round trip under autograd gives the plain version's
    gradient (each op's backward is the other's kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    rng = np.random.default_rng(10 * p + c)
    gen = torch.Generator(device=dev).manual_seed(10 * p + c)
    row_bytes = p * c * (2 if dt == torch.bfloat16 else 4)
    for grid, k in _PATCH_MASKS:
        h = grid * p
        order = np.argsort(rng.random((3, grid * grid)), axis=1)
        kept, inv = visible_ids(torch.from_numpy((order >= k).astype(np.float32)).to(dev), k)
        x = torch.randn(3, h, h, c, generator=gen, device=dev).to(dt)
        xg = torch.randn(3, k, p, p, c, generator=gen, device=dev).to(dt)
        ref_g = ps.gather_patches_plain(x, kept, p, grid)
        ref_s = ps.scatter_patches_plain(xg, kept, p, grid, h)
        before = dict(ps.LAUNCHES)
        got_g = ps._gather(x, kept, p, grid)
        got_s = ps._scatter(xg, kept, inv, p, grid, h)
        torch.cuda.synchronize()
        assert {n: ps.LAUNCHES[n] - before[n] for n in before} == {
            "gather_patches": 1, "scatter_patches": 1}
        assert torch.equal(got_g, ref_g), f"gather grid={grid} K={k}"
        assert torch.equal(got_s, ref_s), f"scatter grid={grid} K={k}"
        for src, scatter, ids in ((x, False, kept), (xg, True, inv)):
            assert ps.launch_plan(src, ids, p, grid, scatter).bulk == (row_bytes % 16 == 0)
        # one or two elements into a larger buffer: no 16-byte aligned base
        for off in (1, 2):
            shift = off * x.element_size()
            vec = max(v for v in (8, 4, 2) if row_bytes % v == 0 and shift % v == 0)
            xo = torch.empty(x.numel() + off, dtype=dt, device=dev)[off:].view(x.shape)
            xo.copy_(x)
            plan = ps.launch_plan(xo, kept, p, grid, False)
            assert not plan.bulk and plan.vec == vec
            assert torch.equal(ps._gather(xo, kept, p, grid), ref_g), f"gather offset {off}"
            xgo = torch.empty(xg.numel() + off, dtype=dt, device=dev)[off:].view(xg.shape)
            xgo.copy_(xg)
            plan = ps.launch_plan(xgo, inv, p, grid, True)
            assert not plan.bulk and plan.vec == vec
            got_s = ps._scatter(xgo, kept, inv, p, grid, h)
            assert torch.equal(got_s, ref_s), f"scatter offset {off}"
        # gather -> scatter under autograd: dx = gather's VJP of scatter's VJP
        w = torch.randn(3, h, h, c, generator=gen, device=dev).to(dt)
        grads = []
        for fwd in ((ps.gather_patches, ps.scatter_patches),
                    (lambda a, kk, ii, pp, gg: ps.gather_patches_plain(a, kk, pp, gg),
                     lambda a, kk, ii, pp, gg, hh: ps.scatter_patches_plain(a, kk, pp, gg, hh))):
            xr = x.clone().requires_grad_(True)
            y = fwd[1](fwd[0](xr, kept, inv, p, grid) * 2, kept, inv, p, grid, h)
            (y * w).sum().backward()
            grads.append(xr.grad)
        assert torch.equal(grads[0], grads[1]), f"round trip grid={grid} K={k}"


# (p, C): every patch side at C = 37 (staged with scalar loads), 24 and the
# atto to tiny widths (16-byte copies), C = 1536 at p <= 2, and p = 16 at
# the pico and tiny stage-0 widths of 112/16 (C = 64, 96)
_DWG_CASES = ([(p, c) for p in (8, 4, 2, 1) for c in (37, 24, 40, 80, 160, 320, 768)]
              + [(2, 1536), (1, 1536), (16, 64), (16, 96)])
# (grid, K): one visible patch (fully masked neighbourhoods, border patches),
# 19 of 49 (the pretraining mask), no masked patch, and a 14-patch grid
_DWG_MASKS = [(7, 1), (7, 19), (7, 49), (14, 1), (14, 77), (14, 196)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("p,c", _DWG_CASES)
def test_dwconv7_gathered_tiles_match_plain_on_gpu(dtype, p, c):
    """The tiled dwconv7_gathered kernels against the plain versions on the
    same inputs at odd N = 3, for each mask of ``_DWG_MASKS``: one launch
    per direction; the output and dx in bf16 within one bf16 ulp plus 1e-4
    of their scale (as chip_smoke.py phase 2), in f32 within 1e-5 of each
    value plus 1e-5 of the scale (f32 sums in another order, TF32 off); dK
    and db (f32 sums reordered by atomics) within 1e-3 of each value plus
    1e-5 of the largest; dK in the param's (C, 1, 7, 7) layout."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    rng = np.random.default_rng(100 * p + c)
    gen = torch.Generator(device=dev).manual_seed(100 * p + c)
    for grid, k in _DWG_MASKS:
        order = np.argsort(rng.random((3, grid * grid)), axis=1)
        kept, inv = visible_ids(torch.from_numpy((order >= k).astype(np.float32)).to(dev), k)
        xg = torch.randn(3, k, p, p, c, generator=gen, device=dev).to(dt)
        dy = torch.randn(3, k, p, p, c, generator=gen, device=dev).to(dt)
        w = torch.randn(c, 1, 7, 7, generator=gen, device=dev)
        b = torch.randn(c, generator=gen, device=dev)
        before = dict(wb.LAUNCHES)
        got = wb.dwconv7_gathered_fwd(xg, kept, inv, w, b, grid)
        dx, dk, db = wb.dwconv7_gathered_bwd(dy, xg, kept, inv, w, grid)
        torch.cuda.synchronize()
        assert {n: wb.LAUNCHES[n] - before[n] for n in before} == {
            "dwconv7_gathered_fwd": 1, "dwconv7_gathered_bwd": 1}
        ref = wb.dwconv7_gathered_plain(xg, kept, w, b, grid)
        rdx, rdk, rdb = wb.dwconv7_gathered_bwd_plain(dy, xg, kept, w, grid)
        assert dk.shape == (c, 1, 7, 7) and db.shape == (c,) and float(rdx.abs().max()) > 0
        for name, a, r in (("out", got, ref), ("dx", dx, rdx)):
            if dt == torch.bfloat16:
                _ulp_close(a, r, 1e-4)
            else:
                torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5 * float(r.abs().max()),
                                           msg=f"{name} grid={grid} K={k}")
        for name, a, r in (("dK", dk, rdk), ("db", db, rdb)):
            bad = (a - r).abs() > 1e-3 * r.abs() + 1e-5 * r.abs().max()
            assert not bool(bad.any()), f"{name} grid={grid} K={k}: {int(bad.sum())} off"


def _ulp_close(got, ref, scale_frac):
    """Within one bf16 ulp of the plain value plus ``scale_frac`` of its scale."""
    if ref.numel() == 0:  # no kept slot to hold
        return
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    assert bool(((got.float() - ref).abs() <= ulp + scale_frac * ref.abs().max()).all())


def _sum_close(got, ref):
    """f32 sums in another order (tensor-core tiles, atomics across blocks)."""
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max()))


# (C, rows per group, groups): the atto stages, then wider rows, where D
# and the masked passes take their wide plans and spill-g C its separate
# dW2 pass (C = 384, 768; 1536 in bf16, and in f32 in the _WIDEST cases below)
_ATTO = [(40, 350, 1), (40, 350, 2), (80, 130, 2), (160, 300, 1), (320, 150, 2)]
_WIDE = [(384, 70, 2), (768, 40, 2)]
_SPILLG_CASES = ([(d, *case) for d in ("bfloat16", "float32") for case in _ATTO + _WIDE]
                 + [("bfloat16", 1536, 20, 2),
                    # groups of fewer rows than half a tile, 45 not a multiple of 16
                    ("bfloat16", 320, 45, 3)])
# past this bf16 width (huge's C = 2816) D's dLN sums are held against those
# of its own stored dv
_SPILLG_DLN_OWN_DV_C = 1616


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c,group_rows,groups", _SPILLG_CASES)
def test_spillg_kernels_match_plain_on_gpu(dtype, c, group_rows, groups):
    """Each spill-g launch against its plain phase on the same inputs, forward
    and backward, one and two GRN groups, ragged row tiles; C's dW2 from the
    one launch where its plan folds it (every atto width in bf16), else from
    its separate pass."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    scale = 1e-4 if dtype == "bfloat16" else 1e-5
    if dtype == "bfloat16" and c > 320:
        # chip_smoke.py's term for bf16 at full size: a product operand (u, h)
        # is rounded from an f32 value summed in another order, and where that
        # rounding flips, g, y and dv move by an operand ulp times a weight
        scale = 2e-3
    _spillg_parity(dtype, c, group_rows, groups, scale)


def _spillg_parity(dtype, c, group_rows, groups, scale, u_flips=False):
    """Every spill-g launch against its plain phase (see
    ``test_spillg_kernels_match_plain_on_gpu``); g, y, dv and u within one
    bf16 ulp plus ``scale`` of their scale; in bf16 past C = 1616, D's dLN
    sums against those of its own stored dv.  ``u_flips`` (bf16 at a stage's
    full size, where D's LN, summed in another order, rounds some u one ulp
    the other way): u and dv within one ulp plus 1e-4 of scale, dv in the
    rows whose u flipped against the plain dv of D's own u, at most 0.1% of
    dv off the plain dv, and the dLN sums against those of that reference
    dv (the plain sums where no u flipped)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(c + groups)
    m, c4 = group_rows * groups, 4 * c

    def rnd(*shape, s=1.0, mean=0.0):
        return mean + s * torch.randn(*shape, generator=gen, device=dev)

    t, x, dy = rnd(m, c).to(dt), rnd(m, c).to(dt), rnd(m, c).to(dt)
    lw, lb, b1, b2 = rnd(c, s=0.1, mean=1.0), rnd(c, s=0.1), rnd(c4, s=0.1), rnd(c, s=0.1)
    w1, w2 = rnd(c4, c, s=0.1), rnd(c, c4, s=0.1)
    gm, bt = rnd(c4, s=0.5), rnd(c4, s=0.1)

    g, gxsq = fb._fwd_a_cuda(t, lw, lb, w1, b1, group_rows)
    rg, rgxsq = fb.fwd_a_plain(t, lw, lb, w1, b1, group_rows)
    _ulp_close(g, rg, scale)
    # A sums the squares of the g it stores, and g may sit one ulp from the
    # plain g: with few rows a group's sum can move by more than the sum's own
    # order noise, so hold it against the stored g
    gf = g.float()
    _sum_close(gxsq, (gf * gf).reshape(-1, group_rows, c4).sum(1))

    y, gx, nx = fb._fwd_b_cuda(rg, x, rgxsq, gm, bt, w2, b2, group_rows)
    ry, rgx, rnx = fb.fwd_b_plain(rg, x, rgxsq, gm, bt, w2, b2, group_rows)
    _ulp_close(y, ry, scale)
    _sum_close(gx, rgx)
    _sum_close(nx, rnx)

    wts, rwts = fb._bwd_weights_cuda(w1, w2, dt), fb.bwd_weights_plain(w1, w2, dt)
    fold = fb.tail_plan(dy, "spillg_bwd_c", group_rows)[0].fold > 0
    before = dict(fb.LAUNCHES)
    got_c = fb._bwd_c_cuda(dy, rg, rnx, gm, bt, wts, group_rows)
    assert {k: fb.LAUNCHES[k] - before[k] for k in ("spillg_bwd_c", "spillg_bwd_c_dw2")} == {
        "spillg_bwd_c": 1, "spillg_bwd_c_dw2": 0 if fold else 1}
    ref_c = fb.bwd_c_plain(dy, rg, rnx, gm, bt, rwts, group_rows)
    for got, ref in zip(got_c[:4], ref_c[:4]):
        _sum_close(got, ref)
    h = fb.h_plain(rg, rnx, gm, bt, group_rows)
    _sum_close(got_c[4], fb.atb_plain(dy, h))

    dgxg = fb.dgx_step(ref_c[3], rgx)
    rdt, rdb1, rdlnw, rdlnb, rdv, ru = fb.bwd_d_plain(t, dy, rg, rnx, dgxg, lw, lb, rwts,
                                                      b1, gm, group_rows)
    dt_k, db1, dlnw, dlnb, dv, u = fb._bwd_d_cuda(t, dy, rg, rnx, dgxg, lw, lb, wts, b1, gm,
                                                  group_rows)
    _ulp_close(dt_k, rdt, 1e-3 if dtype == "bfloat16" else 1e-5)
    _ulp_close(u, ru, 1e-4 if u_flips else scale)
    sums = (rdb1, rdlnw, rdlnb)
    if u_flips:
        flipped = (u != ru).any(1)
        ref_dv = rdv.clone()
        if bool(flipped.any()):
            # the plain dv of the rows whose stored u flipped, from that u
            cd = rdv.dtype
            v = fb._mm(u[flipped], rwts.w1.t(), cd) + b1.float()
            dh = fb._mm(dy[flipped], rwts.w2t.t(), cd)
            grp = fb._per_row(torch.arange(groups, device=dev), group_rows)[flipped]
            dg = dh * (gm.float() * rnx[grp] + 1.0) + rg[flipped].float() * dgxg[grp]
            ref_dv[flipped] = (dg * fb._gelu_grad(v)).to(cd)
            du = fb._mm(ref_dv, rwts.w1, cd)
            _, uhat, _ = fb._ln(t.float(), lw, lb)
            sums = (rdb1, (du * uhat).sum(0), du.sum(0))
        _ulp_close(dv, ref_dv, 1e-4)
        assert float((dv != rdv).float().mean()) <= 1e-3
    else:
        _ulp_close(dv, rdv, scale)
    if dtype == "bfloat16" and c > _SPILLG_DLN_OWN_DV_C:
        # huge's C = 2816: du sums 4C = 11,264 products of the bf16 dv that D
        # stores, and where dv rounds one ulp the other way (about 1% of it)
        # a few rows' dLN sums move past the f32 bound: hold them against the
        # sums of the stored dv (as A's sum of squares against the stored g
        # above), and dv itself to the plain dv in all but a few elements, so
        # that a dv off everywhere cannot pass
        assert float((dv != rdv).float().mean()) < 0.05
        _, uhat, _ = fb._ln(t.float(), lw, lb)
        du = dv.float() @ w1.to(dt).float()
        sums = (rdb1, (du * uhat).sum(0), du.sum(0))
    for got, ref in zip((db1, dlnw, dlnb), sums):
        _sum_close(got, ref)
    _sum_close(fb._atb_cuda(dv, u, "spillg_bwd_d_dw1"), fb.atb_plain(dv, u))


# the widths whose resident layout does not fit an H100 block: huge's last
# stage in bf16, large's and huge's in f32
_WIDEST = [("bfloat16", 2816), ("float32", 1536), ("float32", 2816)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", _WIDEST)
def test_spillg_refuses_rows_wider_than_shared_memory(dtype, c):
    """Rows wider than a block's shared memory holds at 16 rows no longer
    raise: every spill-g launch runs (D on its wide plan) and matches its
    plain phase, at 48 rows in two GRN groups, with the tolerances of
    ``test_spillg_kernels_match_plain_on_gpu`` at wide C."""
    test_spillg_kernels_match_plain_on_gpu(dtype, c, 24, 2)


# keep patterns: about 40% of the rows kept ("random"), none kept, all kept,
# and the first GRN group with no kept row
_KEEPS = ("random", "none", "all", "empty_group")
_MASKED_CASES = ([(d, *case, "random") for d in ("bfloat16", "float32") for case in _ATTO + _WIDE]
                 + [("bfloat16", 1536, 20, 2, "random")]
                 # groups of more than one 4096-row chunk of the kept-row list
                 + [("bfloat16", 40, 5000, 2, "random"), ("float32", 80, 4100, 1, "random")]
                 + [(d, c, gr, 2, k) for d in ("bfloat16", "float32") for c, gr in ((40, 350),
                                                                                     (320, 150))
                    for k in _KEEPS[1:]])


def _keep_of(kind, m, group_rows, gen, dt):
    """(M, 1) keep values of one of the ``_KEEPS`` patterns."""
    dev = gen.device
    if kind == "none":
        return torch.zeros(m, 1, device=dev, dtype=dt)
    if kind == "all":
        return torch.ones(m, 1, device=dev, dtype=dt)
    keep = (torch.rand(m, 1, generator=gen, device=dev) > 0.6).to(dt)
    if kind == "empty_group":
        keep[:group_rows] = 0
    return keep


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c,group_rows,groups,keep_kind", _MASKED_CASES)
def test_masked_kernels_match_plain_on_gpu(dtype, c, group_rows, groups, keep_kind):
    """Each masked-dense launch against its plain phase on the same inputs
    (keep of ``_KEEPS``), forward and backward, one and two GRN groups,
    ragged row tiles, groups of more than one chunk of the kept-row list:
    the list bit-exact; y, dt and every sum in full; the stored do, h, dv
    and u at the kept slots of the list; masked rows give y = x and dt = 0
    exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(c + groups)
    m, c4 = group_rows * groups, 4 * c

    def rnd(*shape, s=1.0, mean=0.0):
        return mean + s * torch.randn(*shape, generator=gen, device=dev)

    t, x, dy = rnd(m, c).to(dt), rnd(m, c).to(dt), rnd(m, c).to(dt)
    keep = _keep_of(keep_kind, m, group_rows, gen, dt)
    masked = keep[:, 0] == 0
    lw, lb, b1, b2 = rnd(c, s=0.1, mean=1.0), rnd(c, s=0.1), rnd(c4, s=0.1), rnd(c, s=0.1)
    w1, w2 = rnd(c4, c, s=0.1), rnd(c, c4, s=0.1)
    gm, bt = rnd(c4, s=0.5), rnd(c4, s=0.1)
    # chip_smoke.py's term in bf16: every pass recomputes v in its own order,
    # so the product operands u and h may round the other way
    scale = 2e-3 if dtype == "bfloat16" else 1e-5
    gr = group_rows

    rows = fb._masked_rows_cuda(keep, gr)
    ref_rows = fb.kept_rows_plain(keep, gr)
    assert torch.equal(rows.ids, ref_rows.ids) and torch.equal(rows.cnt, ref_rows.cnt)
    slots = fb.kept_slots(ref_rows, gr)

    gxsq = fb._masked_fwd_stat_cuda(t, keep, rows, lw, lb, w1, b1, gr)
    rgxsq = fb.masked_fwd_stat_plain(t, keep, ref_rows, lw, lb, w1, b1, gr)
    _sum_close(gxsq, rgxsq)
    ap_args = (t, x, keep, rows, rgxsq, lw, lb, w1, b1, gm, bt, w2, b2, gr)
    y, gx, nx = fb._masked_fwd_apply_cuda(*ap_args)
    ry, rgx, rnx = fb.masked_fwd_apply_plain(*ap_args)
    _ulp_close(y, ry, scale)
    assert torch.equal(y[masked], x[masked])
    _sum_close(gx, rgx)
    _sum_close(nx, rnx)

    st_args = (t, dy, keep, rows, rnx, lw, lb, w1, b1, gm, bt, w2, gr)
    got, ref = fb._masked_bwd_stat_cuda(*st_args), fb.masked_bwd_stat_plain(*st_args)
    for a, r in zip(got[:4], ref[:4]):
        _sum_close(a, r)
    assert torch.equal(got[4][slots], ref[4][slots])  # do = dy * keep, rounded once
    _ulp_close(got[5][slots], ref[5][slots], scale)  # h
    do, h = ref[4], ref[5]
    _sum_close(fb._masked_dw2_cuda(do, h, rows, gr), fb.masked_atb_plain(do, h, ref_rows, gr))

    dgxg = fb.dgx_step(ref[3], rgx)
    dv_args = (t, do, keep, rows, rnx, dgxg, lw, lb, w1, b1, gm, w2, gr)
    dt_k, db1, dlnw, dlnb, dv, u = fb._masked_bwd_dv_cuda(*dv_args)
    rdt, rdb1, rdlnw, rdlnb, rdv, ru = fb.masked_bwd_dv_plain(*dv_args)
    _ulp_close(dt_k, rdt, 1e-3 if dtype == "bfloat16" else 1e-5)
    assert not dt_k[masked].any()
    _ulp_close(dv[slots], rdv[slots], scale)
    _ulp_close(u[slots], ru[slots], scale)
    for a, r in ((db1, rdb1), (dlnw, rdlnw), (dlnb, rdlnb)):
        _sum_close(a, r)
    _sum_close(fb._masked_dw1_cuda(rdv, ru, rows, gr), fb.masked_atb_plain(rdv, ru, ref_rows, gr))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", _WIDEST)
def test_masked_refuses_rows_wider_than_shared_memory(dtype, c):
    """Rows wider than a block's shared memory holds at 16 rows no longer
    raise: every masked-dense launch runs (on its wide plan) and matches its
    plain phase, at 48 rows in two GRN groups, with the tolerances of
    ``test_masked_kernels_match_plain_on_gpu``."""
    test_masked_kernels_match_plain_on_gpu(dtype, c, 24, 2, "random")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", _WIDEST)
def test_wide_plans_are_taken_only_past_the_resident_layout(dtype, c):
    """The launches that have a wide plan take it at the widest stages and
    keep a plan with their C-wide operands in shared memory (no scratch) at
    every atto width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    for width, wide in ((c, True), (40, False), (320, False)):
        t = torch.empty(32, width, device=dev, dtype=dt)
        for key in (*fb.MASKED_KINDS, "spillg_bwd_d"):
            assert (fb.tail_plan(t, key, 16)[0].mode == "wide") == wide, (key, width)


# (dtype, C) -> each masked launch's mode: the weights resident where they
# fit twice on an SM (both tails of C = 40, the forward statistic of C = 80),
# else streamed through the ring, and wide where the C-wide row operands do
# not fit
_MASKED_MODES = {
    ("bfloat16", 40): ("resident",) * 4,
    ("bfloat16", 80): ("resident", "ring", "ring", "ring"),
    ("bfloat16", 160): ("ring",) * 4,
    ("bfloat16", 320): ("ring",) * 4,
    ("bfloat16", 2816): ("wide",) * 4,
    ("float32", 2816): ("wide",) * 4,
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", list(_MASKED_MODES))
def test_masked_plans_per_stage_width(dtype, c):
    """At the atto stage widths (batch 256, every site of the 56/28/14/7
    grid) and huge's C = 2816 (4,864 rows): each masked launch's mode, a
    row tile of 64 (bf16) or 32 (f32) rows, its shared memory within the
    card's, persistent blocks no more than fit at once nor than its virtual
    tiles, and a column split only on the statistic passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    props = torch.cuda.get_device_properties(dev)
    m = {40: 256 * 56 * 56, 80: 256 * 28 * 28, 160: 256 * 14 * 14, 320: 256 * 7 * 7}.get(c, 4864)
    t = torch.empty(m, c, device=dev, dtype=dt)
    for key, mode in zip(fb.MASKED_KINDS, _MASKED_MODES[(dtype, c)]):
        plan, _ = fb.tail_plan(t, key, m)
        assert plan.mode == mode, (key, plan)
        assert plan.bm == (64 if dtype == "bfloat16" else 32)
        assert plan.smem <= props.shared_memory_per_block_optin
        assert 1 <= plan.blocks <= min(plan.per_sm * props.multi_processor_count, plan.tiles)
        assert plan.col_split >= 1 and (plan.col_split == 1 or key in (
            "masked_fwd_stat", "masked_bwd_stat"))


# (dtype, C) -> the spill-g backward's plans: C's mode, whether it folds dW2
# (its slice of dW2 in registers: every atto width in bf16) and its row tile
# (half a tile where the fold then takes at most 3 m-tiles a warp: stages
# 0-1); D's mode and row tile (half a tile on the ring where that still gives
# every block two tiles: stages 0-2); then the forward's: A's mode and column
# split (W1's column tiles of the block resident, at the fewest splits of 4C
# that fit two blocks an SM with the threads' partial column sums; huge's
# C = 2816 wide, split by occupancy: None)
# and B's mode and column split (W2's rows of the block resident at C <= 80,
# else a ring; C's output columns in slices of 160 past C = 160)
_SPILLG_PLANS = {
    ("bfloat16", 40): ("resident", True, 32, "ring", 32, "resident", 1, "resident", 1),
    ("bfloat16", 80): ("resident", True, 32, "ring", 32, "resident", 2, "resident", 1),
    ("bfloat16", 160): ("resident", True, 64, "ring", 32, "resident", 5, "ring", 1),
    ("bfloat16", 320): ("resident", True, 64, "ring", 64, "resident", 20, "ring", 2),
    ("bfloat16", 2816): ("ring", False, 64, "wide", 64, "wide", None, "ring", 18),
    ("float32", 2816): ("ring", False, 32, "wide", 32, "wide", None, "ring", 18),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", list(_SPILLG_PLANS))
def test_spillg_plans_per_stage_width(dtype, c):
    """At the atto stage widths (batch 256, 19 of 49 patches of p x p rows,
    p = 8/4/2/1) and huge's C = 2816 (4,864 rows): C's and D's modes, C's
    fold and both row tiles; C's blocks at least one a 64-column slice of 4C
    and no more than fit at once beyond that; D's no more than fit at once
    nor than its tiles; A's and B's modes, row tiles and column splits, their
    blocks (over blockIdx.x) no more than their tiles and, times the split,
    no more than fit at once; shared memory within the card's.  Then every spill-g
    launch against its plain phase at about the stage's rows, in one and two
    GRN groups whose ends are not a multiple of a row tile, where the plans
    are the ones asserted (checked there too): in bf16 g and y with
    chip_smoke.py's term for the outputs of rounded operands at full size
    (2e-3 of scale), u and dv as ``_spillg_parity``'s ``u_flips`` says at
    the atto widths, and at C = 2816 as
    ``test_spillg_kernels_match_plain_on_gpu`` holds that width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    props = torch.cuda.get_device_properties(dev)
    m = {40: 256 * 19 * 64, 80: 256 * 19 * 16, 160: 256 * 19 * 4, 320: 256 * 19}.get(c, 4864)
    c_mode, fold, c_bm, d_mode, d_bm, a_mode, a_split, b_mode, b_split = _SPILLG_PLANS[(dtype, c)]
    slices = -(-4 * c // 64)
    bf16 = dtype == "bfloat16"
    # the stage's rows, then one and two groups of 19 rows fewer each
    for gr, groups in ((m, 1), (m - 19, 1), (m // 2 - 19, 2)):
        t = torch.empty(gr * groups, c, device=dev, dtype=dt)
        pc, _ = fb.tail_plan(t, "spillg_bwd_c", gr)
        pd, _ = fb.tail_plan(t, "spillg_bwd_d", gr)
        assert (pc.mode, pc.fold > 0, pc.bm, pd.mode, pd.bm) == (
            c_mode, fold, c_bm, d_mode, d_bm), (gr, groups, pc, pd)
        assert pc.col_split == slices and pd.col_split == 1
        assert pc.tiles == groups * -(-gr // c_bm) and pd.tiles == groups * -(-gr // d_bm)
        assert slices <= pc.blocks <= max(slices, pc.per_sm * props.multi_processor_count)
        assert 1 <= pd.blocks <= min(pd.per_sm * props.multi_processor_count, pd.tiles)
        assert max(pc.smem, pd.smem) <= props.shared_memory_per_block_optin
        for key, mode, split in (("spillg_fwd_a", a_mode, a_split),
                                 ("spillg_fwd_b", b_mode, b_split)):
            plan, _ = fb.tail_plan(t, key, gr)
            assert plan.mode == mode and plan.bm == (64 if bf16 else 32), (key, gr, plan)
            assert plan.col_split == split if split else plan.col_split >= 1, (key, gr, plan)
            assert plan.tiles == groups * -(-gr // plan.bm), (key, gr, plan)
            assert 1 <= plan.blocks <= plan.tiles, (key, gr, plan)
            assert plan.blocks * plan.col_split <= max(
                plan.col_split, plan.per_sm * props.multi_processor_count), (key, gr, plan)
            assert plan.smem <= props.shared_memory_per_block_optin, (key, gr, plan)
        if gr != m:
            _spillg_parity(dtype, c, gr, groups, 2e-3 if bf16 else 1e-5, bf16 and c <= 320)
        del t
        torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(40, 80, 160, 320), (96, 192, 384, 768)])
def test_masked_dense_fused_encoder_matches_cpu(dims):
    """The masked-dense encoder with ``--block_impl fused`` at atto and tiny
    widths, one block a stage, two GRN groups, a ragged mask, in f32: the
    kernels on the card against the plain versions on the CPU, output and
    every param grad within 1e-3 of their scale (summation order only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import copy

    from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = ConvNeXtV2(depths=(1, 1, 1, 1), dims=dims, grn_group=2, block_impl="fused",
                     sparse_impl="masked_dense")
    cpu.init_weights(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 56, 56, 12, generator=gen)
    order = torch.argsort(torch.rand(4, GRID * GRID, generator=gen), dim=1)
    mask = (order >= torch.tensor([[12], [19], [25], [31]])).float()  # ragged
    ct = torch.randn(4, GRID, GRID, dims[-1], generator=gen)
    fb_before = dict(fb.LAUNCHES)
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        y = model.encode(x.to(dev), mask.to(dev))
        y.backward(ct.to(dev))
        out[name] = (y.detach().cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()
                                        if p.grad is not None})
    assert fb.LAUNCHES["masked_bwd_dv"] == fb_before["masked_bwd_dv"] + 4
    assert fb.LAUNCHES["masked_rows"] == fb_before["masked_rows"] + 4
    (y_cpu, g_cpu), (y_gpu, g_gpu) = out["cpu"], out["gpu"]
    assert g_cpu.keys() == g_gpu.keys() and len(g_cpu) > 0
    for name, got, ref in [("y", y_gpu, y_cpu)] + [(k, g_gpu[k], g_cpu[k]) for k in g_cpu]:
        err = float((got - ref).abs().max() / (ref.abs().max() + 1e-12))
        assert err < 1e-3, f"{name}: {err:.2e} of scale"


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(48, 96, 192, 384), (96, 192, 384, 768)])
def test_wholeblock_encoder_matches_cpu_at_femto_and_tiny_widths(dims):
    """The spill-g encoder at femto and tiny widths, one block a stage, two GRN
    groups, in f32 (D at 32 rows at C = 384 and at 16 rows at C = 768): the
    kernels on the card against the plain versions on the CPU, output and
    every param grad within 1e-3 of their scale (summation order only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import copy

    from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
    from mmearth_tpu_torch.models.fcmae import gen_random_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = ConvNeXtV2(depths=(1, 1, 1, 1), dims=dims, grn_group=2, block_impl="wholeblock")
    cpu.init_weights(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 56, 56, 12, generator=gen)
    mask = gen_random_mask(4, GRID * GRID, 0.6, gen)
    ct = torch.randn(4, GRID, GRID, dims[-1], generator=gen)
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        y = model.encode(x.to(dev), mask.to(dev), K)
        y.backward(ct.to(dev))
        out[name] = (y.detach().cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()
                                        if p.grad is not None})
    (y_cpu, g_cpu), (y_gpu, g_gpu) = out["cpu"], out["gpu"]
    assert g_cpu.keys() == g_gpu.keys() and len(g_cpu) > 0
    for name, got, ref in [("y", y_gpu, y_cpu)] + [(k, g_gpu[k], g_cpu[k]) for k in g_cpu]:
        err = float((got - ref).abs().max() / (ref.abs().max() + 1e-12))
        assert err < 1e-3, f"{name}: {err:.2e} of scale"


@pytest.mark.gpu
@pytest.mark.parametrize("block_impl", ["auto", "wholeblock"])
def test_gathered_encoder_at_112_16_matches_cpu(block_impl):
    """The gathered encoder at 112 px / patch 16 (pico widths 64/128/256/512,
    one block a stage, two GRN groups: dwconv7_gathered at p = 16/8/4/2) in
    f32: the kernels on the card against the plain versions on the CPU,
    output and every param grad within 1e-3 of their scale (summation order
    only); stage 0 launches the p = 16 kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import copy

    from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
    from mmearth_tpu_torch.models.fcmae import gen_random_mask

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = (64, 128, 256, 512)
    cpu = ConvNeXtV2(patch_size=16, img_size=112, depths=(1, 1, 1, 1), dims=dims, grn_group=2,
                     block_impl=block_impl)
    cpu.init_weights(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(4, 112, 112, 12, generator=gen)
    mask = gen_random_mask(4, GRID * GRID, 0.6, gen)
    ct = torch.randn(4, GRID, GRID, dims[-1], generator=gen)
    before = dict(wb.LAUNCHES)
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        y = model.encode(x.to(dev), mask.to(dev), K)
        y.backward(ct.to(dev))
        out[name] = (y.detach().cpu(), {k: p.grad.cpu() for k, p in model.named_parameters()
                                        if p.grad is not None})
    assert {k: wb.LAUNCHES[k] - before[k] for k in before} == {
        "dwconv7_gathered_fwd": 4, "dwconv7_gathered_bwd": 4}
    (y_cpu, g_cpu), (y_gpu, g_gpu) = out["cpu"], out["gpu"]
    assert g_cpu.keys() == g_gpu.keys() and len(g_cpu) > 0
    for name, got, ref in [("y", y_gpu, y_cpu)] + [(k, g_gpu[k], g_cpu[k]) for k in g_cpu]:
        err = float((got - ref).abs().max() / (ref.abs().max() + 1e-12))
        assert err < 1e-3, f"{name}: {err:.2e} of scale"


# (N, H, C): the finetune slice's four stages at batch 32, the decoder's
# 7x7x512 and the masked-dense stages at a cut batch, huge's widest stage,
# odd N and odd C
_DW_CASES = [(32, 64, 40), (32, 32, 80), (32, 16, 160), (32, 8, 320), (64, 7, 512),
             (16, 56, 40), (16, 28, 80), (16, 14, 160), (16, 7, 320), (8, 14, 768),
             (3, 7, 2816), (5, 9, 37)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,h,c", _DW_CASES)
def test_dw_weight_grad_matches_plain_on_gpu(dtype, n, h, c):
    """The dense dwconv's weight-gradient kernel against its plain version on
    the same inputs: f32 sums in another order (per-thread partials, shared
    and global atomics), within 1e-3 of each value plus 1e-4 of the largest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from mmearth_tpu_torch.ops import dwconv

    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(n + h + c)
    x = torch.randn(n, h, h, c, generator=gen, device=dev).to(dt)
    dy = torch.randn(n, h, h, c, generator=gen, device=dev).to(dt)
    before = dwconv.LAUNCHES["dw_weight_grad"]
    got = dwconv.dw_weight_grad(x, dy)
    torch.cuda.synchronize()
    assert dwconv.LAUNCHES["dw_weight_grad"] == before + 1
    ref = dwconv.dw_weight_grad_plain(x, dy)
    assert got.shape == ref.shape == (c, 1, 7, 7)
    _sum_close(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("n,h,c", [(64, 7, 512), (16, 56, 40), (16, 14, 160)])
def test_dwconv7x7_grads_match_cpu(n, h, c):
    """``dwconv7x7`` on the card (cuDNN forward and dx, the dW kernel) against
    the CPU (plain dW) at the decoder's and the masked-dense stages' shapes,
    in f32 with TF32 off: output and all three grads within 1e-4 of their
    scale (summation order only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from mmearth_tpu_torch.ops import dwconv

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(c)
    x, dy = torch.randn(n, h, h, c, generator=gen), torch.randn(n, h, h, c, generator=gen)
    w, b = 0.1 * torch.randn(c, 1, 7, 7, generator=gen), torch.randn(c, generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, w, b)]
        y = dwconv.dwconv7x7(*leaves)
        y.backward(dy.to(dev))
        out[dev] = [y.detach().cpu()] + [t.grad.cpu() for t in leaves]
    for name, got, ref in zip(("y", "dx", "dW", "db"), out["cuda"], out["cpu"]):
        err = float((got - ref).abs().max() / ref.abs().max())
        assert err < 1e-4, f"{name}: {err:.2e} of scale"


@pytest.mark.gpu
def test_classifier_step_matches_cpu():
    """A finetune step of the dense classifier (two blocks a stage at atto
    widths, drop path 0, f32, TF32 off) on the card against the CPU: loss
    within 1e-4 relative, every grad within 1e-3 of its scale (summation
    order only, as the FCMAE steps of chip_smoke.py); the backward launches
    the dW kernel once per block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    import copy

    from mmearth_tpu_torch.losses.finetune import smoothed_cross_entropy
    from mmearth_tpu_torch.models.convnextv2 import ConvNeXtV2
    from mmearth_tpu_torch.ops import dwconv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = ConvNeXtV2(depths=(2, 2, 2, 2), dims=(40, 80, 160, 320), sparse=False,
                     num_classes=10, head_init_scale=1.0)
    cpu.init_weights(torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(8, 64, 64, 12, generator=gen)
    y = torch.randint(0, 10, (8,), generator=gen)
    before = dwconv.LAUNCHES["dw_weight_grad"]
    out = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        dev = next(model.parameters()).device
        loss = smoothed_cross_entropy(model(x.to(dev)), y.to(dev), 0.2)
        loss.backward()
        out[name] = (float(loss.detach()), {k: p.grad.cpu() for k, p in model.named_parameters()})
    assert dwconv.LAUNCHES["dw_weight_grad"] == before + 8
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out["gpu"]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    for k in g_cpu:
        err = float((g_gpu[k] - g_cpu[k]).abs().max() / (g_cpu[k].abs().max() + 1e-12))
        assert err < 1e-3, f"{k}: {err:.2e} of scale"


@pytest.mark.gpu
@pytest.mark.parametrize("sparse_impl,block_impl,update_freq", [
    ("gathered", "wholeblock", 1), ("masked_dense", "fused", 1), ("gathered", "wholeblock", 2)])
def test_chained_graph_matches_eager_steps_on_gpu(sparse_impl, block_impl, update_freq):
    """A small f32 FCMAE: 4 eager pretrain steps, then the same 4 steps from
    the same state as 2 replays of a 2-step ChainedStep graph.  Losses within
    1e-5 relative and params within 1e-5 (atomics reorder f32 sums between
    runs; lr 1e-3); the capture recorded an eager step's launches a step,
    and the replays ran them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from mmearth_tpu_torch import ops
    from mmearth_tpu_torch.configs import modalities as M
    from mmearth_tpu_torch.data.synthetic import bench_batch
    from mmearth_tpu_torch.models.fcmae import FCMAE
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.step import ChainedStep, pretrain_step, to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(img_size=56, patch_size=8, depths=(1, 1, 1, 1), dims=(40, 80, 160, 320),
              decoder_embed_dim=64, grn_group=4, block_impl=block_impl,
              sparse_impl=sparse_impl, inp_modalities=M.INP_MODALITIES,
              out_modalities=M.OUT_MODALITIES)
    batch = to_device(bench_batch(4, 64, seed=1), "cuda")
    runs = []
    for chained in (False, True):
        model = FCMAE(**kw).init_weights(torch.Generator().manual_seed(0)).cuda()
        opt = AdamW(model.named_parameters(), lambda n: 1e-3, update_freq=update_freq)
        gen = torch.Generator(device="cuda").manual_seed(0)
        before = ops.launch_counts()
        if chained:
            ch = ChainedStep(model, opt, {k: v.expand(2, *v.shape) for k, v in batch.items()})
            losses = torch.cat([ch(0, gen)[1], ch(2, gen)[1]])
            assert ch.steps == {"eager": 2, "recorded": 2, "replayed": 4}
            assert len(ch.graphs) == 1 and opt.count == 4 // update_freq
            ((_, recorded),) = ch.recorded.items()
            assert {k: 2 * n for k, n in per_step.items()} == recorded
            assert ch.replayed == {k: 4 * n for k, n in per_step.items()}
        else:
            losses = torch.stack([pretrain_step(model, opt, batch, i, gen)["loss"]
                                  for i in range(4)])
            after = ops.launch_counts()
            per_step = {k: (after[k] - before[k]) // 4 for k in after}
            assert any(per_step.values())
        runs.append((losses.float().cpu(), [p.detach().cpu() for p in model.parameters()]))
    (l0, p0), (l1, p1) = runs
    torch.testing.assert_close(l1, l0, rtol=1e-5, atol=0)
    for a, b in zip(p1, p0):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_pinned_loader_and_device_batches_on_gpu(tmp_path):
    """A loader asked to pin yields pinned tensors holding the numpy loader's
    batches; ``device_batches`` puts them on the card unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from mmearth_tpu_torch.data.loader import PackedDataset, PackedLoader
    from mmearth_tpu_torch.data.synthetic import generate_packed
    from mmearth_tpu_torch.train.step import device_batches

    ds = PackedDataset(generate_packed(tmp_path, n=20, tile=16, seed=0) / "train")
    plain = list(PackedLoader(ds, batch_size=4, seed=1))
    pinned = list(PackedLoader(ds, batch_size=4, seed=1, pin_memory=True))
    on_card = list(device_batches(iter(pinned), "cuda"))
    torch.cuda.synchronize()
    assert len(plain) == len(pinned) == len(on_card) == 4
    for a, b, c in zip(plain, pinned, on_card):
        assert a.keys() == b.keys() == c.keys()
        for k in a:
            assert b[k].is_pinned() and c[k].is_cuda
            np.testing.assert_array_equal(b[k].numpy(), a[k])
            np.testing.assert_array_equal(c[k].cpu().numpy(), a[k])

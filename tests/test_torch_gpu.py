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
    """The CUDA kernels against their plain versions (needs a GPU and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev = torch.device("cuda")
    order = np.argsort(np.random.default_rng(1).random((8, GRID * GRID)), axis=1)
    mask = torch.from_numpy((order >= K).astype(np.float32)).to(dev)
    kept, inv = visible_ids(mask, K)
    for p, c in ((8, 40), (4, 80), (2, 160), (1, 320)):
        h = GRID * p
        x = torch.randn(8, h, h, c, device=dev, dtype=torch.bfloat16)
        xg = ps._gather(x, kept, p, GRID)
        assert torch.equal(xg, ps.gather_patches_plain(x, kept, p, GRID))
        assert torch.equal(ps._scatter(xg, kept, inv, p, GRID, h),
                           ps.scatter_patches_plain(xg, kept, p, GRID, h))
        w, b = torch.randn(c, 1, 7, 7, device=dev), torch.randn(c, device=dev)
        ref = wb.dwconv7_gathered_plain(xg, kept, w, b, GRID).float()
        got = wb._fwd_cuda(xg, kept, inv, w, b, GRID).float()
        assert float((got - ref).abs().max()) <= 2 ** -6 * float(ref.abs().max())
        dx, dk, db = wb._bwd_cuda(xg, xg, kept, inv, w, GRID)
        rdx, rdk, rdb = wb.dwconv7_gathered_bwd_plain(xg, xg, kept, w, GRID)
        assert float((dx.float() - rdx.float()).abs().max()) <= 2 ** -6 * float(rdx.abs().max())
        torch.testing.assert_close(dk, rdk, rtol=1e-3, atol=1e-3 * float(rdk.abs().max()))
        torch.testing.assert_close(db, rdb, rtol=1e-3, atol=1e-3 * float(rdb.abs().max()))


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
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    assert bool(((got.float() - ref).abs() <= ulp + scale_frac * ref.abs().max()).all())


def _sum_close(got, ref):
    """f32 sums in another order (tensor-core tiles, atomics across blocks)."""
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max()))


# (C, rows per group, groups): the atto stages, then wider rows, where D's
# tile drops to 32 rows (C = 384, 768) and to 16 (C = 1536 in bf16; f32 at
# 1536 takes D's wide plan, held in the _WIDEST cases below)
_ATTO = [(40, 350, 1), (40, 350, 2), (80, 130, 2), (160, 300, 1), (320, 150, 2)]
_WIDE = [(384, 70, 2), (768, 40, 2)]
_SPILLG_CASES = ([(d, *case) for d in ("bfloat16", "float32") for case in _ATTO + _WIDE]
                 + [("bfloat16", 1536, 20, 2)])
# the widest bf16 C whose 16-row tile D holds in an H100 block's shared
# memory; past it D takes its wide plan
_SPILLG_BF16_RESIDENT_C = 1616


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c,group_rows,groups", _SPILLG_CASES)
def test_spillg_kernels_match_plain_on_gpu(dtype, c, group_rows, groups):
    """Each spill-g launch against its plain phase on the same inputs, forward
    and backward, one and two GRN groups, ragged row tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
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
    scale = 1e-4 if dtype == "bfloat16" else 1e-5
    if dtype == "bfloat16" and c > 320:
        # chip_smoke.py's term for bf16 at full size: a product operand (u, h)
        # is rounded from an f32 value summed in another order, and where that
        # rounding flips, g, y and dv move by an operand ulp times a weight
        scale = 2e-3

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

    for got, ref in zip(fb._bwd_c_cuda(dy, rg, rnx, gm, w2, group_rows),
                        fb.bwd_c_plain(dy, rg, rnx, gm, w2, group_rows)):
        _sum_close(got, ref)
    h = fb.h_plain(rg, rnx, gm, bt, group_rows)
    _sum_close(fb._atb_cuda(dy, rg, "spillg_bwd_c_dw2", (rnx, gm, bt, group_rows)),
               fb.atb_plain(dy, h))

    dgxg = fb.dgx_step(fb.bwd_c_plain(dy, rg, rnx, gm, w2, group_rows)[3], rgx)
    dt_k, db1, dlnw, dlnb, dv, u = fb._bwd_d_cuda(t, dy, rg, rnx, dgxg, lw, lb, w1, b1, gm, w2,
                                                  group_rows)
    rdt, rdb1, rdlnw, rdlnb, rdv, ru = fb.bwd_d_plain(t, dy, rg, rnx, dgxg, lw, lb, w1,
                                                      b1, gm, w2, group_rows)
    _ulp_close(dt_k, rdt, 1e-3 if dtype == "bfloat16" else 1e-5)
    _ulp_close(dv, rdv, scale)
    _ulp_close(u, ru, scale)
    if dtype == "bfloat16" and c > _SPILLG_BF16_RESIDENT_C:
        # D's wide plan (huge's C = 2816): du sums 4C = 11,264 products of the
        # bf16 dv that D stores, and where dv rounds one ulp the other way
        # (about 1% of it) a few rows' dLN sums move past the f32 bound: hold
        # them against the sums of the stored dv (as A's sum of squares
        # against the stored g above), and dv itself to the plain dv in all
        # but a few elements, so that a dv off everywhere cannot pass
        assert float((dv != rdv).float().mean()) < 0.05
        _, uhat, _ = fb._ln(t.float(), lw, lb)
        du = dv.float() @ w1.to(dt).float()
        rdlnw, rdlnb = (du * uhat).sum(0), du.sum(0)
    for got, ref in ((db1, rdb1), (dlnw, rdlnw), (dlnb, rdlnb)):
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


_MASKED_CASES = ([(d, *case) for d in ("bfloat16", "float32") for case in _ATTO + _WIDE]
                 + [("bfloat16", 1536, 20, 2)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c,group_rows,groups", _MASKED_CASES)
def test_masked_kernels_match_plain_on_gpu(dtype, c, group_rows, groups):
    """Each masked-dense launch against its plain phase on the same inputs
    (about 40% of the rows kept), forward and backward, one and two GRN
    groups, ragged row tiles; masked rows give y = x and dt = 0 exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(c + groups)
    m, c4 = group_rows * groups, 4 * c

    def rnd(*shape, s=1.0, mean=0.0):
        return mean + s * torch.randn(*shape, generator=gen, device=dev)

    t, x, dy = rnd(m, c).to(dt), rnd(m, c).to(dt), rnd(m, c).to(dt)
    keep = (torch.rand(m, 1, generator=gen, device=dev) > 0.6).to(dt)
    masked = keep[:, 0] == 0
    lw, lb, b1, b2 = rnd(c, s=0.1, mean=1.0), rnd(c, s=0.1), rnd(c4, s=0.1), rnd(c, s=0.1)
    w1, w2 = rnd(c4, c, s=0.1), rnd(c, c4, s=0.1)
    gm, bt = rnd(c4, s=0.5), rnd(c4, s=0.1)
    # chip_smoke.py's term in bf16: every pass recomputes v in its own order,
    # so the product operands u and h may round the other way
    scale = 2e-3 if dtype == "bfloat16" else 1e-5

    gxsq = fb._masked_fwd_stat_cuda(t, keep, lw, lb, w1, b1, group_rows)
    rgxsq = fb.masked_fwd_stat_plain(t, keep, lw, lb, w1, b1, group_rows)
    _sum_close(gxsq, rgxsq)
    y, gx, nx = fb._masked_fwd_apply_cuda(t, x, keep, rgxsq, lw, lb, w1, b1, gm, bt, w2, b2,
                                          group_rows)
    ry, rgx, rnx = fb.masked_fwd_apply_plain(t, x, keep, rgxsq, lw, lb, w1, b1, gm, bt, w2, b2,
                                             group_rows)
    _ulp_close(y, ry, scale)
    assert torch.equal(y[masked], x[masked])
    _sum_close(gx, rgx)
    _sum_close(nx, rnx)

    got = fb._masked_bwd_stat_cuda(t, dy, keep, rnx, lw, lb, w1, b1, gm, bt, w2, group_rows)
    ref = fb.masked_bwd_stat_plain(t, dy, keep, rnx, lw, lb, w1, b1, gm, bt, w2, group_rows)
    for a, r in zip(got[:4], ref[:4]):
        _sum_close(a, r)
    assert torch.equal(got[4], ref[4])  # do = dy * keep, rounded once
    _ulp_close(got[5], ref[5], scale)  # h
    do, h = ref[4], ref[5]
    _sum_close(fb._masked_dw2_cuda(do, h), fb.atb_plain(do, h))

    dgxg = fb.dgx_step(ref[3], rgx)
    dv_args = (t, do, keep, rnx, dgxg, lw, lb, w1, b1, gm, w2, group_rows)
    dt_k, db1, dlnw, dlnb, dv, u = fb._masked_bwd_dv_cuda(*dv_args)
    rdt, rdb1, rdlnw, rdlnb, rdv, ru = fb.masked_bwd_dv_plain(*dv_args)
    _ulp_close(dt_k, rdt, 1e-3 if dtype == "bfloat16" else 1e-5)
    assert not dt_k[masked].any()
    _ulp_close(dv, rdv, scale)
    _ulp_close(u, ru, scale)
    for a, r in ((db1, rdb1), (dlnw, rdlnw), (dlnb, rdlnb)):
        _sum_close(a, r)
    _sum_close(fb._masked_dw1_cuda(dv, u), fb.atb_plain(dv, u))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", _WIDEST)
def test_masked_refuses_rows_wider_than_shared_memory(dtype, c):
    """Rows wider than a block's shared memory holds at 16 rows no longer
    raise: every masked-dense launch runs (the apply, statistic and dv
    passes on their wide plans where the resident layout does not fit) and
    matches its plain phase, at 48 rows in two GRN groups, with the
    tolerances of ``test_masked_kernels_match_plain_on_gpu``."""
    test_masked_kernels_match_plain_on_gpu(dtype, c, 24, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", _WIDEST)
def test_wide_plans_are_taken_only_past_the_resident_layout(dtype, c):
    """The launches that have a wide plan take it at the widest stages and
    keep their resident plan (no scratch) at every atto width."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    for key in fb._WIDE_KINDS:
        for width, wide in ((c, key != "masked_bwd_stat" or dtype == "float32"),
                            (40, False), (320, False)):
            t = torch.empty(32, width, device=dev, dtype=dt)
            acc, u = fb._wide_scratch(t, key, 16)
            assert (acc is not None or u is not None) == wide, (key, width)


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

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


def _ulp_close(got, ref, scale_frac):
    """Within one bf16 ulp of the plain value plus ``scale_frac`` of its scale."""
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    assert bool(((got.float() - ref).abs() <= ulp + scale_frac * ref.abs().max()).all())


def _sum_close(got, ref):
    """f32 sums in another order (tensor-core tiles, atomics across blocks)."""
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4 * float(ref.abs().max()))


# (C, rows per group, groups): the atto stages, then wider rows, where D's
# tile drops to 32 rows (C = 384, 768) and to 16 (C = 1536, bf16 only: f32
# takes C <= 960 on an H100)
_ATTO = [(40, 350, 1), (40, 350, 2), (80, 130, 2), (160, 300, 1), (320, 150, 2)]
_WIDE = [(384, 70, 2), (768, 40, 2)]
_SPILLG_CASES = ([(d, *case) for d in ("bfloat16", "float32") for case in _ATTO + _WIDE]
                 + [("bfloat16", 1536, 20, 2)])


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
    for got, ref in ((db1, rdb1), (dlnw, rdlnw), (dlnb, rdlnb)):
        _sum_close(got, ref)
    _sum_close(fb._atb_cuda(dv, u, "spillg_bwd_d_dw1"), fb.atb_plain(dv, u))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", [("bfloat16", 2816), ("float32", 1536)])
def test_spillg_refuses_rows_wider_than_shared_memory(dtype, c):
    """Past the widest C whose 16-row tile fits a block's shared memory, the
    wrappers raise before launching, naming the limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev, dt = torch.device("cuda"), getattr(torch, dtype)
    t = torch.zeros(32, c, device=dev, dtype=dt)
    lw, lb = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    w1, b1 = torch.zeros(4 * c, c, device=dev), torch.zeros(4 * c, device=dev)
    with pytest.raises(ValueError, match="wider than the spill-g kernels take"):
        fb._fwd_a_cuda(t, lw, lb, w1, b1, 32)


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

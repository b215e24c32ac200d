"""The launch plans of the patch gather/scatter kernels (``copy_plan``), on the CPU.

The kernels in ``csrc/patch_select.cu`` run only on a GPU; the plan they
run with is made in Python and checked here: the groups the blocks take in
turn cover every output row chunk exactly once, the bulk-copy path is
taken only where the row and both pointers allow 16-byte bulk copies, a
block's shared memory fits the card, and the chunks of a wide row add up
to the row.  The kernels' unit address math, mirrored here in numpy, turns
the plan's units into the plain gather and scatter."""
import numpy as np
import pytest
import torch

from mmearth_tpu_torch.ops import patch_select as ps

H100_OPTIN = 232448  # shared memory a block may opt in to on an H100 (227 KB)
H100_SMEM_SM, H100_SMS = 233472, 132  # shared memory an SM (228 KB), SMs


def h100_occupancy(scatter, bulk, vec, smem):
    """Blocks an SM on an H100 by shared memory (1 KB reserved a block), 32
    blocks and 2,048 threads at most (a bulk block is one warp, a
    register-path block ``REG_WARPS``)."""
    threads = 32 if bulk else 32 * ps.REG_WARPS
    return min(32, 2048 // threads, H100_SMEM_SM // (smem + 1024))


# (p, C, elem bytes): the atto stages, pico-112/16's stem and stage 3, huge's
# last width, and rows that are not a multiple of 16 bytes
SHAPES = [(8, 40, 2), (1, 320, 2), (16, 64, 2), (2, 512, 2), (1, 2816, 4), (1, 2816, 2),
          (8, 37, 2), (1, 37, 2), (1, 37, 4), (2, 37, 2), (1, 24, 2)]


def _plan(rows, row_bytes, scatter, align=16, optin=H100_OPTIN):
    return ps.copy_plan(rows, row_bytes, align, scatter, H100_SMS, h100_occupancy, optin)


def _unit_ranges(plan):
    """(start, length) in output bytes of every unit, in the order the
    blocks (on the register path, the warps) walk them in turn, and each
    unit's index."""
    walkers = plan.blocks * (1 if plan.bulk else ps.REG_WARPS)
    units = []
    for w in range(walkers):
        for g in range(w, plan.groups, walkers):
            units.extend(range(g * plan.group, min((g + 1) * plan.group, plan.units)))
    u = np.asarray(units, dtype=np.int64)
    row, ch = u // plan.chunks, u % plan.chunks
    length = np.minimum(plan.chunk_bytes, plan.row_bytes - ch * plan.chunk_bytes)
    return row * plan.row_bytes + ch * plan.chunk_bytes, length, u


@pytest.mark.parametrize("scatter", [False, True])
@pytest.mark.parametrize("p,c,eb", SHAPES)
def test_units_cover_every_output_chunk_once(p, c, eb, scatter):
    """At batch 256 (19 of 49 patches kept), on the path the 16-byte aligned
    pointers select and, where the row allows 8-byte vectors, on the
    register path that 8-byte aligned pointers select: the groups the
    blocks take in turn are disjoint and cover the groups, on a grid of the
    blocks the card holds at once or fewer (one group a block, a warp on
    the register path); their units tile the output's bytes exactly once;
    a bulk group fits its slot (at most one unit a lane, a chunk of a wide
    row alone), every bulk copy is a 16-byte multiple."""
    rows = 256 * (49 if scatter else 19) * p
    row_bytes = p * c * eb
    for align in ([16, 8] if row_bytes % 8 == 0 else [16]):
        plan = _plan(rows, row_bytes, scatter, align)
        assert plan.bulk == (row_bytes % 16 == 0 and align == 16)
        start, length, u = _unit_ranges(plan)
        assert np.array_equal(np.sort(u), np.arange(plan.units))
        order = np.argsort(start)
        start, length = start[order], length[order]
        assert start[0] == 0 and np.all(start[1:] == start[:-1] + length[:-1])
        assert start[-1] + length[-1] == rows * row_bytes
        warps = 1 if plan.bulk else ps.REG_WARPS
        resident = h100_occupancy(scatter, plan.bulk, plan.vec, plan.smem)
        assert plan.blocks == min(H100_SMS * resident, -(-plan.groups // warps))
        if plan.bulk:
            assert plan.group * plan.chunk_bytes <= plan.slot_bytes and plan.group <= 32
            assert plan.chunks == 1 or plan.group == 1
            assert np.all(length % 16 == 0) and plan.slots >= 3
        else:
            assert plan.chunks == 1 and plan.group == ps.REG_GROUP


@pytest.mark.parametrize("row_bytes", [640, 2048, 11264, 592, 74, 48, 148, 296, 96, 60])
@pytest.mark.parametrize("align", [16, 8, 4, 2])
def test_bulk_path_only_where_row_and_pointers_allow(row_bytes, align):
    """The bulk path exactly where the row is a multiple of 16 bytes and both
    pointers 16-byte aligned; else the register path with the widest vector
    (8, 4 or 2 bytes) that divides the row and the pointers.  A row or a
    pointer that is not 2-byte aligned raises."""
    for scatter in (False, True):
        plan = _plan(1000, row_bytes, scatter, align)
        allowed = row_bytes % 16 == 0 and align == 16
        assert plan.bulk == allowed
        if allowed:
            assert plan.vec == 16
            assert plan.smem == ps.bulk_smem(plan.slots, plan.slot_bytes, scatter)
        else:
            assert plan.smem == 0 and plan.slots == 0
            assert plan.vec == max(v for v in (8, 4, 2) if row_bytes % v == 0 and align % v == 0)
        with pytest.raises(ValueError, match="not 2-byte aligned"):
            _plan(1000, row_bytes, scatter, 1)


def test_pointer_alignment():
    """The alignment the plan's rule reads: the largest of 16/8/4/2/1 bytes
    dividing every pointer (an element into a bf16 or f32 buffer)."""
    assert ps.pointer_align(0x7f0000000200, 0x7f0000001000) == 16
    assert ps.pointer_align(0x7f0000000202, 0x7f0000001000) == 2
    assert ps.pointer_align(0x7f0000000204, 0x7f0000001008) == 4
    assert ps.pointer_align(0x7f0000000208) == 8
    assert ps.pointer_align(0x7f0000000201) == 1


@pytest.mark.parametrize("optin", [H100_OPTIN, 101376, 49152, 12288])
@pytest.mark.parametrize("p,c,eb", SHAPES)
def test_slot_fits_opt_in_shared_memory(p, c, eb, optin):
    """A bulk block's shared memory is what the kernel lays out and never
    exceeds the card's opt-in shared memory; on a smaller card the slot
    shrinks (a wide row in more chunks)."""
    row_bytes = p * c * eb
    if row_bytes % 16:
        return
    for scatter in (False, True):
        plan = _plan(4864, row_bytes, scatter, optin=optin)
        assert plan.bulk and plan.smem == ps.bulk_smem(plan.slots, plan.slot_bytes, scatter)
        assert plan.smem <= optin and plan.slot_bytes % 128 == 0
        assert plan.chunk_bytes <= plan.slot_bytes


@pytest.mark.parametrize("eb", [2, 4])
@pytest.mark.parametrize("c", [2816, 1536, 4104])
def test_wide_row_chunks_add_up_to_the_row(c, eb):
    """A row wider than a slot (C = 2816 at p = 1 in f32: 11,264 bytes) is cut
    into chunks of one slot at most, 16-byte multiples, that add up to the
    row; the last is the shorter."""
    row_bytes = c * eb
    plan = _plan(4864, row_bytes, False)
    assert plan.bulk
    chunks = [min(plan.chunk_bytes, row_bytes - i * plan.chunk_bytes) for i in range(plan.chunks)]
    assert sum(chunks) == row_bytes and all(0 < b <= plan.slot_bytes for b in chunks)
    assert all(b % 16 == 0 for b in chunks) and chunks[-1] == min(chunks)
    assert (plan.chunks > 1) == (row_bytes > plan.slot_bytes)


def _copy_by_units(plan, src, ids, n, k, p, grid, scatter):
    """The output bytes the kernels write: each unit's source and destination
    as ``unit_of`` in ``csrc/patch_select.cu`` computes them."""
    u = np.arange(plan.units, dtype=np.int64)
    row, ch = u // plan.chunks, u % plan.chunks
    within = ch * plan.chunk_bytes
    length = np.minimum(plan.chunk_bytes, plan.row_bytes - within)
    h = grid * p
    if not scatter:
        pk, r = row // p, row % p
        nn, pid = pk // k, ids.reshape(-1)[pk]
        py, px = pid // grid, pid % grid
        src_off = ((nn * h + py * p + r) * grid + px) * plan.row_bytes + within
        zero = np.zeros_like(u, dtype=bool)
    else:
        px, ny = row % grid, row // grid
        nn, y = ny // h, ny % h
        py, r = y // p, y % p
        s = ids.reshape(-1)[nn * grid * grid + py * grid + px]
        zero = s >= k
        src_off = ((nn * k + np.where(zero, 0, s)) * p + r) * plan.row_bytes + within
    dst_off = row * plan.row_bytes + within
    out = np.full(plan.units and int(dst_off[-1] + length[-1]), 0xAB, dtype=np.uint8)
    flat = src.reshape(-1)
    for d, s_, ln, z in zip(dst_off, src_off, length, zero):
        out[d:d + ln] = 0 if z else flat[s_:s_ + ln]
    return out


@pytest.mark.parametrize("p,c,eb", [(8, 40, 2), (2, 512, 2), (1, 2816, 4), (1, 37, 2)])
@pytest.mark.parametrize("grid,k", [(7, 1), (7, 19), (7, 49), (14, 77)])
def test_unit_address_math_gives_the_plain_ops(p, c, eb, grid, k):
    """The units' source and destination offsets, in the kernels' order of
    index math, copy the bytes of the plain gather and scatter exactly, at
    odd N = 3 (the chunked rows of C = 2816 in f32 included)."""
    rng = np.random.default_rng(p * c + k)
    n, h = 3, grid * p
    dt = torch.bfloat16 if eb == 2 else torch.float32
    kept = np.sort(np.argsort(rng.random((n, grid * grid)), axis=1)[:, :k], axis=1)
    inv = np.full((n, grid * grid), k, dtype=np.int32)
    for i in range(n):
        inv[i, kept[i]] = np.arange(k)
    kept_t = torch.from_numpy(kept.astype(np.int32))
    x = torch.randn(n, h, h, c, generator=torch.Generator().manual_seed(k)).to(dt)
    xg = torch.randn(n, k, p, p, c, generator=torch.Generator().manual_seed(p)).to(dt)
    as_bytes = lambda t: t.contiguous().view(torch.uint8).numpy().reshape(-1)  # noqa: E731
    g_plan = _plan(n * k * p, p * c * eb, False)
    got = _copy_by_units(g_plan, as_bytes(x), kept, n, k, p, grid, False)
    assert np.array_equal(got, as_bytes(ps.gather_patches_plain(x, kept_t, p, grid)))
    s_plan = _plan(n * grid * grid * p, p * c * eb, True)
    got = _copy_by_units(s_plan, as_bytes(xg), inv, n, k, p, grid, True)
    assert np.array_equal(got, as_bytes(ps.scatter_patches_plain(xg, kept_t, p, grid, h)))

"""The launch shapes of the dwconv7_gathered kernels (``tile_plan``), on the CPU.

The kernels in ``csrc/wholeblock.cu`` run only on a GPU; the tiling they
run with is chosen in Python and checked here: every stage of the atto,
femto and tiny encoders fits an H100's shared memory two blocks an SM, the
channel chunks cover C, and each tile's halo and the patches it looks up
are clipped as the kernel clips them."""
import pytest

from mmearth_tpu_torch.ops import wholeblock as wb

H100_OPTIN = 232448  # shared memory a block may opt in to on an H100 (227 KB)
H100_SMS = 132
WIDTHS = {"atto": (40, 80, 160, 320), "femto": (48, 96, 192, 384), "tiny": (96, 192, 384, 768)}


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("model", sorted(WIDTHS))
def test_plan_fits_two_blocks_an_sm(model, elem_bytes, bwd):
    """At each stage (p = 8/4/2/1) of 56-px (grid 7) and 112-px (grid 14)
    images at batch 256: the block's shared memory is what the kernel lays
    out and leaves room for a second block (1 KB of each reserved); the
    chunk divides C and stays within 64 channels; the tile lies in the grid;
    the threads are whole warps, 64 to 256; the launch gives 132 SMs at
    least three blocks each; 16-byte staging only where C and the chunk
    allow it."""
    for grid in (7, 14):
        for p, c in zip((8, 4, 2, 1), WIDTHS[model]):
            plan = wb.tile_plan(p, grid, c, elem_bytes, 256, bwd, H100_OPTIN, H100_SMS)
            assert plan.smem == wb.smem_bytes(p, plan.tpy, plan.tpx, plan.cc, elem_bytes, bwd)
            assert 2 * (plan.smem + 1024) <= H100_OPTIN
            assert c % plan.cc == 0 and (c // plan.cc) * plan.cc == c and plan.cc <= 64
            assert 1 <= plan.tpy <= grid and 1 <= plan.tpx <= grid
            assert plan.threads % 32 == 0 and 64 <= plan.threads <= 256
            tiles = -(-grid // plan.tpy) * -(-grid // plan.tpx)
            assert 256 * tiles * (c // plan.cc) >= 3 * H100_SMS
            assert plan.vec == (c * elem_bytes % 16 == 0 and plan.cc * elem_bytes % 16 == 0)


@pytest.mark.parametrize("c,cc,vec", [(37, 37, False), (24, 24, True), (1536, 64, True),
                                      (2816, 64, True), (74, 37, False), (72, 24, True)])
def test_chunks_cover_c(c, cc, vec):
    """The chunk is the largest divisor of C up to 64 channels, preferring
    one that 16-byte copies can stage: C = 37 stages with scalar loads,
    C = 72 takes 24-channel chunks (48 bytes) over 36 (72 bytes)."""
    for p in (8, 4, 2, 1):
        plan = wb.tile_plan(p, 7, c, 2, 3, False, H100_OPTIN, H100_SMS)
        assert (plan.cc, plan.vec) == (cc, vec)


@pytest.mark.parametrize("grid", [7, 14])
@pytest.mark.parametrize("p", [16, 8, 4, 2, 1])
def test_tile_windows_clip_at_the_image_edge(p, grid):
    """For tiles of 1 to 4 patches a side, ragged at the image's edge: the
    tiles' patches cover the grid once; a tile's halo is its sites and a
    3-site border (reaching outside the image at its edge); the patches
    whose ids the block looks up are exactly those the halo overlaps,
    ``_border(p)`` of them beyond the tile."""
    lo, e = wb._border(p)
    for tpy, tpx in ((1, 1), (2, 3), (3, 4), (4, 2)):
        tiles = -(-grid // tpy) * -(-grid // tpx)
        seen = set()
        for tile in range(tiles):
            win = wb.tile_window(p, grid, tpy, tpx, tile)
            (py0, py1), (px0, px1) = win["patches"]
            assert 0 <= py0 < py1 <= grid and 0 <= px0 < px1 <= grid
            assert py1 - py0 == min(tpy, grid - py0) and px1 - px0 == min(tpx, grid - px0)
            cells = {(y, x) for y in range(py0, py1) for x in range(px0, px1)}
            assert not cells & seen
            seen |= cells
            for (a0, a1), (q0, q1), (s0, s1) in zip(win["patches"], win["reach"], win["halo"]):
                assert (s0, s1) == (a0 * p - 3, a1 * p + 3)
                assert set(range(q0, q1)) == {s // p for s in range(s0, s1)}
                assert (q0, q1 - q0) == (a0 - lo, a1 - a0 + e)
            if py1 == grid:  # a bottom tile: its halo ends 3 sites past the image
                assert win["halo"][0][1] == grid * p + 3
        assert len(seen) == grid * grid


# stage 0 of 112 px / patch 16 (a 7 x 7 grid of 16 x 16 patches)
STAGE0_112 = {"pico": 64, "tiny": 96}


@pytest.mark.parametrize("bwd", [False, True])
@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("model", sorted(STAGE0_112))
def test_plan_at_patch_side_16_fits_two_blocks_an_sm(model, elem_bytes, bwd):
    """At p = 16 (stage 0 of pico and tiny at 112/16, batch 64 as bench.py's
    tiny112 and 256), bf16 and f32, forward and backward: a plan within the
    two-blocks-an-SM limit of an H100's shared memory, its bytes what the
    kernel lays out (a one-patch tile's bf16 halo is 22 x 22 sites), the
    chunk dividing C, whole warps of threads, and enough blocks."""
    c = STAGE0_112[model]
    for n in (64, 256):
        plan = wb.tile_plan(16, 7, c, elem_bytes, n, bwd, H100_OPTIN, H100_SMS)
        assert plan.smem == wb.smem_bytes(16, plan.tpy, plan.tpx, plan.cc, elem_bytes, bwd)
        assert 2 * (plan.smem + 1024) <= H100_OPTIN
        assert c % plan.cc == 0 and plan.cc <= 64 and plan.vec
        assert 1 <= plan.tpy <= 7 and 1 <= plan.tpx <= 7
        assert plan.threads % 32 == 0 and 64 <= plan.threads <= 256
        tiles = -(-7 // plan.tpy) * -(-7 // plan.tpx)
        assert n * tiles * (c // plan.cc) >= 3 * H100_SMS
    # a one-patch tile of 64 bf16 channels: the 62 KB halo fits (cc = 64)
    assert wb.tile_plan(16, 7, 64, 2, 64, True, H100_OPTIN, H100_SMS).cc == 64
    assert wb.smem_bytes(16, 1, 1, 64, 2, False) >= 22 * 22 * 64 * 2


def test_patch_side_16_is_accepted():
    """p = 16 has its rows a work item (one) and passes the wrapper's check,
    whose border is ceil(3/16) = 1 patch before the tile and 2 in all; a
    side the kernel has no case for (32) is still refused."""
    import torch

    assert wb._ROWS[16] == 1 and wb._border(16) == (1, 2)
    n, k, c, grid = 2, 3, 64, 7
    ids = torch.zeros(n, k, dtype=torch.int32)
    inv = torch.zeros(n, grid * grid, dtype=torch.int32)
    w, b = torch.zeros(c, 1, 7, 7), torch.zeros(c)
    wb._check(torch.zeros(n, k, 16, 16, c), ids, inv, w, b, grid, "dwconv7_gathered")
    with pytest.raises(ValueError, match="p in 1, 2, 4, 8, 16"):
        wb._check(torch.zeros(n, k, 32, 32, c), ids, inv, w, b, grid, "dwconv7_gathered")


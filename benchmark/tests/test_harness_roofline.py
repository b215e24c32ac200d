"""Each roofline operation's work against a hand count at atto56's stage 1
(batch 512: 19 of 49 patches visible, 8 x 8 sites a patch, C = 40, two
Blocks), and the discovery that maps kernels to operations."""
from __future__ import annotations

import json

from conftest import BENCH_DIR

R = 512 * 19 * 64  # 622,592 visible rows at stage 1


def stage1():
    m = json.loads((BENCH_DIR / "configs" / "atto56.json").read_text())["model"]
    return dict(m, depths=[2, 0, 0, 0])


def test_dwconv7_stage1():
    from harness.spec import roofline_operations

    flops, nbytes = roofline_operations()["dwconv7"]["work"](stage1(), 512)
    taps = 50 * 40 * 4  # 49 taps and a bias a channel, f32
    ids = 512 * (19 + 49) * 4  # kept ids and the inverse map, int32
    fwd_bytes = R * 40 * 2 * 2 + taps + ids  # rows in and out, bf16
    bwd_bytes = R * 40 * 2 * 3 + 2 * taps + ids  # dy and x in, dx out; taps in, dK and db out
    assert nbytes == 2 * (fwd_bytes + bwd_bytes) == 2 * (99_761_984 + 149_577_344)
    assert flops == 2 * (2 * 49 * R * 40 + 4 * 49 * R * 40) == 14_643_363_840


def test_block_tail_stage1():
    from harness.spec import roofline_operations

    flops, nbytes = roofline_operations()["block_tail"]["work"](stage1(), 512)
    params = (2 * 160 * 40 + 11 * 40) * 4  # W1, W2; b1 (160), b2, LN w/b, GRN gamma/beta (160 each)
    assert params == 52_960
    fwd = R * 40 * 2 * 3 + params  # t, x in; y out
    bwd = R * 40 * 2 * 3 + 2 * params  # dy, t in; dt out; params in, their grads out
    assert nbytes == 2 * (fwd + bwd)
    assert flops == 2 * (2 * 2 * R * 40 * 160 + 4 * 2 * R * 40 * 160) == 95_630_131_200


def test_operations_and_kernels():
    from harness import groups
    from harness.spec import roofline_operations

    ops = roofline_operations()
    assert set(ops) >= {"dwconv7", "block_tail"}
    names = {"void (anonymous namespace)::dw7_fwd_kernel<__nv_bfloat16, 8, 2>(...)": "dwconv7",
             "void (anonymous namespace)::dw7_bwd_kernel<__nv_bfloat16, 2, 2>(...)": "dwconv7",
             "void (anonymous namespace)::bwd_dv_kernel<__nv_bfloat16, 32, 1, "
             "(anonymous namespace)::SpillRows>(...)": "block_tail",
             "void (anonymous namespace)::spillg_fwd_b_kernel<__nv_bfloat16, 64, 1, 5>(...)":
             "block_tail",
             "void dw7_wgrad_kernel<...>": None,
             "void at::native::vectorized_elementwise_kernel<4, ...>": None}
    for name, op in names.items():
        hit = [k for k, v in ops.items() if any(groups.matches(name, f) for f in v["kernels"])]
        assert hit == ([op] if op else []), (name, hit)

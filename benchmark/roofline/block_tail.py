"""The tail of every encoder Block on its visible rows, forward and
backward: LayerNorm, the C -> 4C product, GELU, GRN over the batch's rows,
the 4C -> C product and the residual.

Per Block of R rows of C channels in bf16 (2 bytes), with its params in f32
(W1 and W2 of 4 C^2 each, and 11 C of biases, LayerNorm and GRN affines):
the forward reads the dwconv's output t and the Block's input x and writes
y, and reads the params; the backward reads y's gradient and t, writes t's
gradient (x's is y's), reads the params and writes their gradients.  The
FLOPs are the two products forward (2 * R * C * 4C each) and their four
backward.  What a kernel spills and reads again (the GELU output g) and
the products it recomputes do not count.
"""
from harness.shapes import encoder_stages

OPERATION = "block_tail"
# csrc/fused_block.cu, the spill-g tail: A (fwd_stat_kernel<..., SpillRows>),
# B (spillg_fwd_b_kernel), C (spillg_bwd_c_kernel, spillg_bwd_c_dw2),
# D (bwd_dv_kernel<..., SpillRows>) and its dW1 sum (spillg_atb_kernel)
KERNELS = (("fwd_stat_kernel", "SpillRows"), "spillg_fwd_b", "spillg_bwd",
           ("bwd_dv_kernel", "SpillRows"), "spillg_atb")


def work(model: dict, batch: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one step."""
    flops = nbytes = 0.0
    for st in encoder_stages(model, batch):
        r, c = st["rows"], st["C"]
        params = (8 * c * c + 11 * c) * 4
        fwd = (3 * r * c * 2 + params, 2 * 2 * r * c * 4 * c)
        bwd = (3 * r * c * 2 + 2 * params, 4 * 2 * r * c * 4 * c)
        nbytes += st["depth"] * (fwd[0] + bwd[0])
        flops += st["depth"] * (fwd[1] + bwd[1])
    return flops, nbytes

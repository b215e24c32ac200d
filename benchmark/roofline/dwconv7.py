"""The gathered 7x7 depthwise convolution of every encoder Block, forward
and backward: the visible rows in, the visible rows out.

Per Block of R rows of C channels in bf16 (2 bytes), taps and bias in f32:
the forward reads the rows, the taps and the bias and writes the rows, and
takes 2 * 49 * R * C FLOPs; the backward reads the output's gradient and
the rows and writes the input's gradient and the taps' and bias' gradients,
and takes twice that (dx and the taps).  The patch index tables (N x K and
N x L int32) are read by both.
"""
from harness.shapes import encoder_stages

OPERATION = "dwconv7"
KERNELS = ("dw7_fwd", "dw7_bwd")  # csrc/wholeblock.cu: dw7_fwd_kernel, dw7_bwd_kernel


def work(model: dict, batch: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one step."""
    grid = model["img_size"] // model["patch_size"]
    visible = int(grid * grid * (1 - model["mask_ratio"]))
    ids = batch * (visible + grid * grid) * 4
    flops = nbytes = 0.0
    for st in encoder_stages(model, batch):
        r, c, taps = st["rows"], st["C"], (49 + 1) * st["C"] * 4
        fwd = (2 * r * c * 2 + taps + ids, 2 * 49 * r * c)
        bwd = (3 * r * c * 2 + 2 * taps + ids, 4 * 49 * r * c)
        nbytes += st["depth"] * (fwd[0] + bwd[0])
        flops += st["depth"] * (fwd[1] + bwd[1])
    return flops, nbytes

"""A roofline operation's share: the least time the card could take for
the operation's work in the traced steps (its FLOPs at the bf16 peak or its
bytes at the HBM rate, whichever is longer) over the device time of the
kernels that implement it."""
from __future__ import annotations

from .peaks import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def share(ctx, operation: str):
    """Percent of the roofline, or None where no kernel of the operation
    ran in the traced window."""
    if ctx.trace is None:
        return None
    op = ctx.operations.get(operation)
    if op is None or op["work"] is None:
        return None
    spent = ctx.trace.seconds_where(op["kernels"])
    if spent <= 0:
        return None
    flops, nbytes = op["work"](ctx.cell.config["model"], ctx.batch)
    return 100.0 * least_seconds(flops, nbytes) * ctx.counts["traced_steps"] / spent

"""composed_ms: device time a step of PyTorch's own elementwise and
reduction kernels (the composed passes around the hand-written kernels),
grouped by the benchmark's frozen kernel table, over the traced steps.
Layer: the step."""

DECLARES = {"unit": "ms/step", "source": "device_trace", "layer": "step",
            "moves": "samples_per_s"}
GROUPS = ("elementwise", "reductions")


def read(ctx):
    if ctx.trace is None:
        return None
    by = ctx.trace.by_group()
    spent = sum(by.get(g, 0.0) for g in GROUPS)
    return 1e3 * spent / ctx.counts["traced_steps"] if spent > 0 else None

"""mfu: the whole step's share of the card's bf16 peak, in percent: the
configuration's ``flops_per_sample`` (the model's products and
convolutions, forward and backward, counted once through the reference)
times the window's samples, over the window's wall time, over 989 TFLOP/s.
Layer: the step (``train/step.py::pretrain_step``, ``train/optim.py``,
``models/``, ``losses/``)."""
from harness.peaks import PEAK_BF16_FLOPS

DECLARES = {"unit": "%", "source": "host_clock", "layer": "step", "moves": "samples_per_s"}


def read(ctx):
    flops = ctx.cell.config["flops_per_sample"] * ctx.counts["samples"]
    return 100.0 * flops / ctx.counts["window_s"] / PEAK_BF16_FLOPS

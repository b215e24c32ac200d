"""block_tail_roofline: the share of its roofline that the block_tail operation
(``benchmark/roofline/``, every file mapped to it) reached in the traced
steps, in percent.  Layer: kernels."""
from harness.rooflines import share

DECLARES = {"unit": "%", "source": "device_trace", "layer": "kernels",
            "moves": "samples_per_s"}


def read(ctx):
    return share(ctx, "block_tail")

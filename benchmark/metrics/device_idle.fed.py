"""device_idle.fed: the share of the traced window in which no kernel,
copy or set ran on the card, in percent.  Layer: dispatch and device
(``train/pretrain.py::Dispatcher``, ``train/step.py::ChainedStep``)."""

DECLARES = {"unit": "%", "source": "device_trace", "layer": "dispatch",
            "moves": "samples_per_s.fed"}


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:  # nothing ran on a device
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)

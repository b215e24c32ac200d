"""input_wait_ms: the host's wait for batches, a span around each ``next()``
on the iterator handed to ``Dispatcher.run``, summed over the window and
divided by its steps.  Layer: the loader (``data/loader.py``,
``data/native/``, ``train/step.py::device_batches``)."""

DECLARES = {"unit": "ms/step", "source": "program_span", "layer": "loader",
            "moves": "samples_per_s.fed"}


def read(ctx):
    return 1e3 * ctx.counts["input_wait_s"] / ctx.counts["steps"]

"""loader_wait_ms: the training thread waiting on the loader's queue (the
program's ``loader.first_wait``, an epoch's first batch, and
``loader.wait``, every later one), a traced step.  Layer: the loader
(``data/loader.py::PackedLoader``)."""
from harness.spans import ms_per_step

DECLARES = {"unit": "ms/step", "source": "program_span", "layer": "loader",
            "moves": "samples_per_s.fed"}


def read(ctx):
    return ms_per_step(ctx, ("loader.first_wait", "loader.wait"))

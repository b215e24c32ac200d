"""gather_ms: the loader's worker busy gathering and pinning batches
(the program's ``loader.gather`` spans, clipped to the traced part), a
traced step.  Layer: the loader (``data/loader.py::PackedLoader``,
``data/native/``)."""
from harness.spans import ms_per_step

DECLARES = {"unit": "ms/step", "source": "program_span", "layer": "loader",
            "moves": "samples_per_s.fed"}


def read(ctx):
    return ms_per_step(ctx, ("loader.gather",))

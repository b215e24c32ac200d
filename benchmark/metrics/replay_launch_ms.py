"""replay_launch_ms: the host inside ``graph.replay()`` (the program's
``dispatch.replay`` spans), a traced step: under 1 ms where the launch
returns at once, near the step's device time where it blocks.  Layer:
dispatch (``train/step.py::ChainedStep``)."""
from harness.spans import ms_per_step

DECLARES = {"unit": "ms/step", "source": "program_span", "layer": "dispatch",
            "moves": "samples_per_s"}


def read(ctx):
    return ms_per_step(ctx, ("dispatch.replay",))

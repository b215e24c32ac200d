"""dispatch_host_ms: the dispatch's own host work, a traced step: the
program's ``dispatch`` spans (the wait for batches, ``dispatch.input``,
lies before each) less their ``dispatch.replay`` (the launch) and any
``graph.capture``, so stacking and ``load`` (``dispatch.stack``), the draws
and host values (``dispatch.prepare``) and the rest.  None without a
replay.  Layer: dispatch (``train/pretrain.py::Dispatcher``, ``train/step.py::ChainedStep``)."""
from harness.spans import ms_per_step

DECLARES = {"unit": "ms/step", "source": "program_span", "layer": "dispatch",
            "moves": "samples_per_s"}


def read(ctx):
    return ms_per_step(ctx, ("dispatch",),
                       less=("dispatch.replay", "graph.capture"),
                       needs=("dispatch.replay",))

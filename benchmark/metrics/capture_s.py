"""capture_s: the seconds of every CUDA graph capture of the process, set-up's
included (the program's ``graph.capture`` spans: warm-up, record,
instantiate).  Layer: dispatch (``train/step.py::ChainedStep._capture``)."""
from harness.spans import recorded

DECLARES = {"unit": "s", "source": "program_span", "layer": "dispatch", "moves": "setup_s"}


def read(ctx):
    spent = sum(s.end_ns - s.start_ns for s in recorded() or () if s.name == "graph.capture")
    return spent / 1e9 if spent > 0 else None

"""The readers of the program's spans (``program_span`` metrics): their
values on a synthetic recorder, None without its spans or without a
recorder at all (a program that predates it), only the traced part
counted; and a traced fed run on the CPU reads the loader's spans."""
from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from conftest import FED

MS = 1_000_000
T0 = 10_000  # ms after the epoch: the spans' times below count from it
READERS = ("gather_ms", "loader_wait_ms", "replay_launch_ms", "dispatch_host_ms", "capture_s")


@pytest.fixture
def recorder(monkeypatch):
    from mmearth_tpu_torch.utils import profiling

    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    profiling.set_recording(False)
    yield rec
    profiling.set_recording(False)


def read(name: str, steps: int = 4):
    from harness.spec import Cell

    ctx = SimpleNamespace(counts={"traced_steps": steps})
    return Cell("atto56.pretrain.fed").reader(name).read(ctx)


def span(name: str, start: float, end: float, thread: int = 1):
    from mmearth_tpu_torch.utils.profiling import Span

    return Span(name, thread, int((T0 + start) * MS), int((T0 + end) * MS), {})


def fill(rec):
    """Set-up's capture (3 s, before the traced part), then two dispatches
    at 100-150 and 150-200 ms, each its input's pull and then its
    ``dispatch`` span; the worker's gathers straddle the part's edges."""
    def add(name, start, end, setup=False, thread=1):
        rec.add(span(name, start, end, thread), setup)

    add("graph.capture", -3000, 0, setup=True)
    add("dispatch.replay", -10, -5)  # set-up's first dispatch, unrecorded but for this
    add("loader.gather", 50, 110, thread=2)  # 10 ms inside
    add("loader.gather", 110, 160, thread=2)
    add("loader.gather", 190, 260, thread=2)  # 10 ms inside
    for start in (100, 150):
        add("dispatch.input", start, start + 12)
        add("dispatch", start + 12, start + 50)
        add("loader.first_wait" if start == 100 else "loader.wait", start + 1, start + 9)
        add("dispatch.stack", start + 12, start + 14)
        add("dispatch.prepare", start + 14, start + 17)
        add("dispatch.replay", start + 17, start + 47)


def test_readers_values_on_a_synthetic_recorder(recorder):
    fill(recorder)
    got = {name: read(name) for name in READERS}
    assert got == pytest.approx({
        "gather_ms": (10 + 50 + 10) / 4, "loader_wait_ms": 2 * 8 / 4,
        "replay_launch_ms": 2 * 30 / 4, "dispatch_host_ms": 2 * (50 - 12 - 30) / 4,
        "capture_s": 3.0})


def test_readers_count_only_the_traced_part(recorder):
    fill(recorder)
    before = {name: read(name) for name in READERS if name != "capture_s"}
    # spans outside the two dispatches change nothing; a capture inside is no host work
    recorder.add(span("loader.wait", 20, 40))
    recorder.add(span("loader.gather", 300, 400, thread=2))
    recorder.add(span("dispatch.replay", 210, 215))
    assert {name: read(name) for name in before} == pytest.approx(before)
    recorder.add(span("graph.capture", 160, 162), True)
    assert read("dispatch_host_ms") == pytest.approx(before["dispatch_host_ms"] - 2 / 4)
    assert read("capture_s") == pytest.approx(3.002)


def test_readers_give_none_without_their_spans(recorder, monkeypatch):
    from mmearth_tpu_torch.utils import profiling

    assert all(read(name) is None for name in READERS)
    # dispatches on the CPU: no replay and no loader, so nothing to read
    recorder.add(span("dispatch", 0, 10))
    recorder.add(span("dispatch.prepare", 1, 2))
    assert all(read(name) is None for name in READERS)
    # a program without the recorder
    monkeypatch.delattr(profiling, "RECORDER")
    assert all(read(name) is None for name in READERS)


def test_traced_fed_run_reads_the_loaders_spans(recorder, make_root):
    from harness import cell as runner
    from harness.spec import Cell

    # a traced part of several epochs (4 batches each), so the worker gathers in it
    root = make_root({**FED, "trace_seconds": 1.0})
    out, counts = runner.run(Cell("tiny.cell", root), 2 ** 33 + 7, 0.5, True, "cpu",
                             time.perf_counter(), lambda msg: None)
    m = out["metrics"]
    assert m["gather_ms"]["value"] > 0 and m["gather_ms"]["unit"] == "ms/step"
    assert m["loader_wait_ms"]["value"] >= 0
    # the CPU has no graph: nothing replayed or captured
    assert not {"replay_launch_ms", "dispatch_host_ms", "capture_s"} & set(m)
    dispatches = [s for s in recorder.spans() if s.name == "dispatch"]
    assert len(dispatches) == counts["traced_dispatches"]
    batches = recorder.counters()["loader.batches"]
    assert recorder.counters()["loader.bytes"] % batches == 0

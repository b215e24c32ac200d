"""The port's span and counter recorder (``utils/profiling.py``): off it
records nothing, spans nest per thread, the buffer keeps its cap, its clock
is the profiler's, and the loader, ``Dispatcher`` and ``ChainedStep`` record
the spans the benchmark and the epoch line read.  The capture's spans need a
card (``-m gpu``).  This file imports neither JAX nor the JAX package."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from mmearth_tpu_torch.data.loader import PackedDataset, PackedLoader
from mmearth_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh recorder for each test, off at the start and at the end."""
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    profiling.set_recording(False)
    yield rec
    profiling.set_recording(False)


def test_off_records_nothing(recorder):
    assert profiling.span("a") is profiling.span("b", batch=1)  # the one shared no-op
    with profiling.span("a", step=0) as sp:
        sp.note(bytes=1)
    profiling.count("c", 3)
    assert recorder.spans() == [] and recorder.counters() == {}
    # set-up spans are recorded all the same
    with profiling.span("graph.capture", setup=True):
        pass
    assert [s.name for s in recorder.spans()] == ["graph.capture"]


def test_spans_nest_with_parents_per_thread(recorder):
    """Spans nest in time on each thread, the worker's on its own thread
    id; each name's total holds every span's nanoseconds."""
    profiling.set_recording(True)

    def worker():
        with profiling.span("w.outer", batch=0):
            with profiling.span("w.inner"):
                pass

    with profiling.span("outer", step=4):
        with profiling.span("inner") as sp:
            sp.note(rows=2)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    by = {s.name: s for s in recorder.spans()}
    assert set(by) == {"outer", "inner", "w.outer", "w.inner"}
    assert by["outer"].ids == {"step": 4} and by["inner"].ids == {"rows": 2}
    assert by["w.outer"].ids == {"batch": 0}
    assert by["w.outer"].thread == by["w.inner"].thread != by["outer"].thread == by["inner"].thread
    for child, parent in (("inner", "outer"), ("w.inner", "w.outer"), ("w.outer", "inner")):
        assert by[parent].start_ns <= by[child].start_ns <= by[child].end_ns <= by[parent].end_ns
    assert recorder.totals() == {s.name: s.end_ns - s.start_ns for s in by.values()}


def test_cap_holds_with_its_drop_count(monkeypatch, tmp_path):
    rec = profiling.Recorder(cap=4)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    profiling.set_recording(True)
    with profiling.span("graph.capture", setup=True):  # kept beside the cap
        pass
    for i in range(10):
        with profiling.span("s", i=i):
            pass
    assert rec.dropped == 6
    assert set(rec.totals()) == {"graph.capture", "s"}  # the dropped spans' time too
    kept = rec.spans()
    assert [s.name for s in kept] == ["graph.capture", "s", "s", "s", "s"]
    assert [s.ids["i"] for s in kept[1:]] == [6, 7, 8, 9]
    trace = json.loads(rec.write(tmp_path / "spans.json").read_text())
    assert trace["otherData"] == {"counters": {}, "dropped": 6}
    ev = trace["traceEvents"]
    assert [e["ph"] for e in ev] == ["X"] * 5 and ev[1]["args"] == {"i": 6}
    assert ev[1]["ts"] == kept[1].start_ns / 1e3  # µs since the Unix epoch
    assert abs(ev[1]["ts"] / 1e6 - time.time()) < 60


def test_clock_is_the_profilers(tmp_path):
    """A span's start and its ``record_function`` twin's ``ts`` x 1e3 +
    ``baseTimeNanoseconds`` agree within 100 µs (the closest of five: a
    preempted thread may stamp one late)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    profiling.set_recording(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):  # the first range pays the profiler's set-up
            pass
        for i in range(5):
            with profiling.span(f"clock.{i}"):
                time.sleep(0.001)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    data = json.loads((tmp_path / "trace.json").read_text())
    base = int(data["baseTimeNanoseconds"])
    twins = {e["name"]: e for e in data["traceEvents"]
             if e.get("ph") == "X" and e["name"].startswith("clock.")}
    assert len(twins) == 5
    gaps = [abs(twins[s.name]["ts"] * 1e3 + base - s.start_ns)
            for s in profiling.RECORDER.spans()]
    assert len(gaps) == 5 and min(gaps) < 100e3


def _pack(path, n: int = 16):
    """A packed split of ``n`` samples with two fields."""
    path.mkdir(parents=True)
    fields = {"a": ((3, 3, 2), np.float32), "b": ((5,), np.int32)}
    for name, (shape, dtype) in fields.items():
        arr = np.lib.format.open_memmap(path / f"{name}.bin", mode="w+", dtype=dtype,
                                        shape=(n, *shape))
        arr[...] = np.arange(arr.size).reshape(arr.shape)
        arr.flush()
    (path / "meta.json").write_text(json.dumps({
        "count": n, "fields": {k: {"shape": list(s), "dtype": np.dtype(d).name}
                               for k, (s, d) in fields.items()}}))
    return PackedDataset(path)


@pytest.mark.parametrize("prefetch", [2, 0])
def test_packed_loader_spans_and_counters(recorder, tmp_path, prefetch):
    loader = PackedLoader(_pack(tmp_path / "train"), batch_size=4, seed=3, prefetch=prefetch)
    profiling.set_recording(True)
    yielded, nbytes = 0, 0
    for epoch in range(2):
        loader.set_epoch(epoch)
        for b in loader:
            yielded += 1
            nbytes += sum(v.nbytes for v in b.values())
    spans = recorder.spans()
    gathers = [s for s in spans if s.name == "loader.gather"]
    assert sorted((s.ids["epoch"], s.ids["batch"]) for s in gathers) == [
        (e, i) for e in range(2) for i in range(4)]
    assert all(s.ids["rows"] == 4 and s.ids["bytes"] == 4 * (18 * 4 + 5 * 4) for s in gathers)
    assert recorder.counters() == {"loader.batches": yielded, "loader.bytes": nbytes}
    assert yielded == 8 and nbytes == 8 * 4 * 92
    first = [s for s in spans if s.name == "loader.first_wait"]
    waits = [s for s in spans if s.name == "loader.wait"]
    if prefetch:
        assert [s.ids for s in first] == [{"epoch": 0, "batch": 0}, {"epoch": 1, "batch": 0}]
        # batches 1-3 of each epoch, then the wait for its end (batch == 4)
        assert sorted((s.ids["epoch"], s.ids["batch"]) for s in waits) == [
            (e, i) for e in range(2) for i in range(1, 5)]
        assert {s.thread for s in gathers}.isdisjoint({s.thread for s in first})
    else:  # gathered on the consumer's thread: nothing to wait for
        assert first == waits == []


def test_dispatcher_spans_k2(recorder):
    """Five batches at k = 2: two chained dispatches and a single step,
    each its input's pull and then one ``dispatch`` span with its children,
    both closed before its yield."""
    from mmearth_tpu_torch.configs import modalities as M
    from mmearth_tpu_torch.data.synthetic import bench_batch
    from mmearth_tpu_torch.models.fcmae import FCMAE
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.pretrain import Dispatcher
    from mmearth_tpu_torch.train.step import to_device

    model = FCMAE(img_size=56, patch_size=8, depths=(1, 1, 1, 1), dims=(8, 8, 8, 16),
                  decoder_embed_dim=16, inp_modalities=M.INP_MODALITIES,
                  out_modalities=M.OUT_MODALITIES).init_weights(torch.Generator().manual_seed(0))
    opt = AdamW(model.named_parameters(), lambda n: 1e-3)
    batches = [to_device(bench_batch(2, 64, seed=i), "cpu") for i in range(5)]
    disp = Dispatcher(model, opt, 2, torch.Generator().manual_seed(0), spans=True)
    starts = []
    for i, losses in enumerate(disp.run(iter(batches), 10)):
        at = time.time_ns()
        done = [s for s in recorder.spans() if s.name == "dispatch"]
        assert len(done) == i + 1 and done[-1].end_ns <= at  # closed before the yield
        starts.append(10 + 2 * i)
    spans = recorder.spans()
    dispatches = {s.ids["step"]: s for s in spans if s.name == "dispatch"}
    assert list(dispatches) == [10, 12, 14] == starts
    # each pull ends before its dispatch opens; the last finds the batches' end
    pulls = {s.ids["step"]: s for s in spans if s.name == "dispatch.input"}
    assert list(pulls) == [10, 12, 14, 15]
    assert all(pulls[i].end_ns <= d.start_ns for i, d in dispatches.items())
    children = {}
    for s in spans:
        if s.name in ("dispatch.stack", "dispatch.prepare"):
            d = dispatches[s.ids["step"]]
            assert d.start_ns <= s.start_ns <= s.end_ns <= d.end_ns
            children.setdefault(s.ids["step"], []).append(s.name)
    assert children == {10: ["dispatch.stack", "dispatch.prepare"],
                        12: ["dispatch.stack", "dispatch.prepare"]}
    ms = profiling.per_step_ms(recorder.totals(), 5)
    assert set(ms) == {"dispatch_host_ms"} and ms["dispatch_host_ms"] > 0  # no replay on the CPU
    # the recorder follows the profiler where spans were not asked for
    disp.spans = False
    next(disp.run(iter(batches[:2]), 15))
    assert len(recorder.spans()) == len(spans)


def test_per_step_ms_sums_by_name():
    """From the totals an epoch added (:func:`since`): the loader's waits
    and gather, the dispatch less its replay and capture, the replay."""
    S = profiling.Span
    ms = 1_000_000
    rec = profiling.Recorder()
    rec.add(S("dispatch", 1, 0, 4 * ms, {}))  # before the epoch
    before = rec.totals()
    for s in [S("dispatch.input", 1, 0, 2 * ms, {}), S("dispatch", 1, 2 * ms, 10 * ms, {}),
              S("loader.first_wait", 1, 0, 1 * ms, {}),
              S("loader.wait", 1, 1 * ms, 2 * ms, {}),
              S("dispatch.replay", 1, 3 * ms, 7 * ms, {}),
              S("loader.gather", 2, 0, 6 * ms, {})]:
        rec.add(s)
    rec.add(S("graph.capture", 1, 2 * ms, 3 * ms, {}), setup=True)
    epoch = profiling.since(rec.totals(), before)
    assert epoch["dispatch"] == 8 * ms
    assert profiling.per_step_ms(epoch, 2) == {
        "loader_wait_ms": 1.0, "gather_ms": 3.0, "dispatch_host_ms": 1.5,
        "replay_launch_ms": 2.0}
    assert profiling.per_step_ms({}, 0) == {}


@pytest.mark.gpu
def test_capture_spans_and_report_on_gpu(recorder):
    """A ChainedStep's capture: one ``graph.capture`` span with its three
    parts, recorded with the recorder off, counted once, and read back by
    ``capture_seconds`` and ``report()``; its replays' spans while on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from mmearth_tpu_torch.configs import modalities as M
    from mmearth_tpu_torch.data.synthetic import bench_batch
    from mmearth_tpu_torch.models.fcmae import FCMAE
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.step import ChainedStep, to_device

    model = FCMAE(img_size=56, patch_size=8, depths=(1, 1, 1, 1), dims=(40, 80, 160, 320),
                  decoder_embed_dim=64, grn_group=4, block_impl="wholeblock",
                  inp_modalities=M.INP_MODALITIES, out_modalities=M.OUT_MODALITIES)
    model = model.init_weights(torch.Generator().manual_seed(0)).cuda()
    opt = AdamW(model.named_parameters(), lambda n: 1e-3)
    batch = to_device(bench_batch(4, 64, seed=1), "cuda")
    ch = ChainedStep(model, opt, {k: v.expand(2, *v.shape) for k, v in batch.items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    ch(0, gen)
    spans = recorder.spans()
    assert [s.name for s in spans] == ["graph.capture", "graph.capture.warmup",
                                       "graph.capture.record", "graph.capture.instantiate"]
    top = spans[0]
    assert all(top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns for s in spans[1:])
    assert recorder.counters() == {"graph.captures": 1}
    ((pattern, parts),) = ch.capture_seconds.items()
    assert pattern in ch.graphs
    assert parts == {s.name.rsplit(".", 1)[1]: (s.end_ns - s.start_ns) / 1e9 for s in spans[1:]}
    assert ch.report()["capture_s"] == parts and sum(parts.values()) <= (
        top.end_ns - top.start_ns) / 1e9
    profiling.set_recording(True)
    ch(2, gen)
    torch.cuda.synchronize()
    names = [s.name for s in recorder.spans()[4:]]
    assert names == ["dispatch.prepare", "dispatch.replay"]
    assert recorder.counters() == {"graph.captures": 1}  # no recapture

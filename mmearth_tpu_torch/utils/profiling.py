"""Profiling and timing (port of ``mmearth_tpu/utils/profiling.py``), on
``torch.profiler``.

- :func:`trace` captures a ``torch.profiler`` trace of a block (CPU ops, and
  the card's kernels where there is one) and writes it as a Chrome trace.
- :func:`summarize_trace` aggregates a written trace's events by name:
  kernels on the card (``device="cuda"``) or CPU ops (``"cpu"``).
- :func:`attribute_trace` buckets the card's time by module, mapping kernel
  symbols to groups (:data:`GROUPS`, :func:`group_of`) where JAX maps HLO
  ``op_name`` metadata.
- :func:`time_steps` is the port's one step timer: best of ``rounds`` rounds
  of ``k`` steps, each round closed by one sync (a pretraining round is one
  ``ChainedStep`` dispatch: on a card one replay of a k-step graph).
- :func:`span` and :func:`count` record the port's own spans and counters
  into :data:`RECORDER` (:class:`Recorder`), on the profiler's clock
  (``time.time_ns()``), from any thread: the loader's worker as well as the
  training thread, whose spans a ``torch.profiler`` trace also shows as
  ``record_function`` ranges.  :func:`per_step_ms` reduces the spans'
  totals by name (:meth:`Recorder.totals`, exact however many spans the
  buffer dropped) to the epoch line's numbers; :meth:`Recorder.write` writes
  the spans as a Chrome trace to load beside the profiler's.

The spans, where they open, and what reads them:

- ``loader.gather`` (ids ``epoch``, ``batch``, ``rows``, ``bytes``): the
  loader's worker gathering (and pinning) a batch (``data/loader.py``);
  counters ``loader.batches`` and ``loader.bytes`` beside it.
- ``loader.first_wait``, ``loader.wait`` (``epoch``, ``batch``): the
  training thread waiting for an epoch's first batch (the worker's start
  and a gather with nothing ahead) and for each later one.
- ``dispatch.input`` (``step``: the dispatch's first step): pulling a
  dispatch's batches (the loader's waits), just before its ``dispatch``
  (``step``), which holds ``dispatch.stack`` (stacking and ``ChainedStep.load``),
  ``dispatch.prepare`` (the draws and the optimizer's host values) and
  ``dispatch.replay`` (``graph.replay()``) (``train/pretrain.py::
  Dispatcher``, ``train/step.py::ChainedStep``).
- ``graph.capture`` and its children ``graph.capture.warmup``, ``.record``
  and ``.instantiate`` (ids ``chain``, ``graph``), counter
  ``graph.captures``: ``ChainedStep``'s capture of each graph, recorded
  whether the recorder is on or not (``ChainedStep.capture_seconds``).

The recorder is on while :func:`set_recording` says so: ``Dispatcher.run``
sets it at each dispatch, on where a profiler runs on its thread or where
it was made with ``spans=True`` (``run_pretrain`` with ``--log_dir``).
Off, a span costs one read of a module flag.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import NamedTuple

import torch

TRACE_FILE = "trace.json"

# kernel-name fragments (a tuple: all of them) -> group, first match wins
GROUPS = (
    ("dw7_wgrad", "dense dwconv dW (port kernel)"),
    (("fwd_stat_kernel", "SpillRows"), "spill-g fwd A (port kernel)"),  # row 7
    ("spillg_fwd_a", "spill-g fwd A (port kernel)"),  # row 7's earlier kernel
    ("spillg_fwd_b", "spill-g fwd B (port kernel)"),  # row 8
    ("spillg_bwd", "spill-g bwd C/D row passes (port kernels)"),
    ("SpillRows", "spill-g bwd C/D row passes (port kernels)"),  # D: bwd_dv_kernel<..., SpillRows>
    ("fwd_stat_kernel", "masked-dense fwd stat/apply (port kernels)"),  # <..., KeptRows>
    ("masked_fwd", "masked-dense fwd stat/apply (port kernels)"),
    ("masked_bwd", "masked-dense bwd stat/dv row passes (port kernels)"),
    ("KeptRows", "masked-dense bwd stat/dv row passes (port kernels)"),
    ("spillg_atb", "dW1/dW2 X^T Y passes (port kernel)"),
    ("dw7_fwd", "dwconv7_gathered fwd (port kernel)"),
    ("dw7_bwd", "dwconv7_gathered bwd (port kernel)"),
    ("patch_copy", "patch gather/scatter (port kernel)"),  # rows 1-2: patch_copy_bulk/_reg
    ("gather_kernel", "patch gather/scatter (port kernel)"),  # their earlier kernels
    ("scatter_kernel", "patch gather/scatter (port kernel)"),
    ("multi_tensor_apply", "optimizer (foreach)"),
    ("gemm", "matmul (cuBLAS)"),
    ("xmma", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("conv", "convolution (cuDNN)"),
    ("cudnn", "convolution (cuDNN)"),
    ("reduce", "reductions"),
    ("Memcpy", "memcpy"),
    ("Memset", "memset"),
    ("elementwise", "elementwise"),
    ("index", "indexing"),
    ("gather", "indexing"),
    ("scatter", "indexing"),
)


def group_of(name: str) -> str:
    low = name.lower()
    for frags, group in GROUPS:
        if all(f.lower() in low for f in ((frags,) if isinstance(frags, str) else frags)):
            return group
    return "other"


@contextmanager
def trace(log_dir: str | Path):
    """Capture a ``torch.profiler`` trace around a block of work (the card's
    kernels too where CUDA is available) and write it to
    ``log_dir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / TRACE_FILE))
    print(f"profiler trace written to {log_dir}")


# the Chrome trace's event categories of each device
_CATEGORIES = {"cuda": ("kernel", "gpu_memcpy", "gpu_memset"), "cpu": ("cpu_op",)}


def _events(log_dir: str | Path, device: str) -> list[dict]:
    path = Path(log_dir) / TRACE_FILE
    assert path.exists(), f"no trace file under {log_dir}"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cats = _CATEGORIES[device]
    return [e for e in events if e.get("ph") == "X" and "dur" in e and e.get("cat") in cats]


def summarize_trace(log_dir: str | Path, top: int = 25,
                    device: str = "cuda") -> list[tuple[str, float, int]]:
    """Aggregate event durations of a trace :func:`trace` wrote.  Returns
    [(name, total_ms, count)] sorted by total time; ``device`` is "cuda"
    (kernels, copies and sets on the card) or "cpu" (CPU ops)."""
    agg, cnt = collections.Counter(), collections.Counter()
    for e in _events(log_dir, device):
        agg[e["name"]] += e["dur"]
        cnt[e["name"]] += 1
    rows = [(name, dur / 1e3, cnt[name]) for name, dur in agg.most_common(top)]
    for name, ms, c in rows:
        print(f"{ms:9.2f} ms  x{c:4d}  {name[:100]}")
    return rows


def attribute_trace(log_dir: str | Path, top: int = 40,
                    device: str = "cuda") -> list[tuple[str, float]]:
    """The card's time in a trace :func:`trace` wrote, bucketed by module:
    each kernel's symbol mapped to its group (:func:`group_of`).  Returns ALL
    [(bucket, total_ms)] sorted by time (callers may sum them for the total);
    only the printout is cut to ``top`` rows."""
    buckets = collections.Counter()
    for e in _events(log_dir, device):
        buckets[group_of(e["name"])] += e["dur"]
    rows = [(k, v / 1e3) for k, v in buckets.most_common(None)]
    for k, ms in rows[:top]:
        print(f"{ms:9.3f} ms  {k}")
    if len(rows) > top:
        rest = sum(ms for _, ms in rows[top:])
        print(f"{rest:9.3f} ms  <{len(rows) - top} more buckets>")
    return rows


def time_steps(dispatch, device: str | torch.device, k: int = 30, rounds: int = 4,
               per_call: int = 1) -> tuple[float, list[float]]:
    """A warm-up round, then ``rounds`` rounds of ``k`` steps, each closed by
    one device sync; ``dispatch(i)`` runs ``per_call`` steps from step ``i``
    (``i`` counts every step, the warm-up's too, so each draws anew): one
    ``ChainedStep`` dispatch of k steps, ``per_call=k``, or one step.
    Returns the best round's ms/step and every timed round's."""
    dev = torch.device(device)
    i, out = 0, []
    for r in range(rounds + 1):
        t0 = time.perf_counter()
        for _ in range(k // per_call):
            dispatch(i)
            i += per_call
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if r > 0:  # round 0 is the warm-up
            out.append(1e3 * (time.perf_counter() - t0) / k)
    return min(out), out


# -- the port's own spans and counters -----------------------------------------

SPAN_CAP = 1 << 16  # spans kept; older ones are dropped and counted


class Span(NamedTuple):
    """One closed span; times are ``time.time_ns()``."""
    name: str
    thread: int
    start_ns: int
    end_ns: int
    ids: dict


class _NoSpan:
    """What :func:`span` returns while the recorder is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **ids) -> None:
        pass


_NO_SPAN = _NoSpan()


class _OpenSpan:
    """A span being recorded: closed by its ``with`` block, on the thread
    that opened it."""

    __slots__ = ("rec", "name", "ids", "setup", "start", "fn")

    def __init__(self, rec: "Recorder", name: str, ids: dict, setup: bool):
        self.rec, self.name, self.ids, self.setup, self.fn = rec, name, ids, setup, None

    def __enter__(self):
        self.start = time.time_ns()
        if torch.autograd._profiler_enabled():  # this thread's profiler, if any
            self.fn = torch.profiler.record_function(self.name)
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self.fn is not None:
            self.fn.__exit__(*exc)
        self.rec.add(Span(self.name, threading.get_native_id(), self.start, time.time_ns(),
                          self.ids), self.setup)
        return False

    def note(self, **ids) -> None:
        """Add ids known only inside the span."""
        self.ids.update(ids)


class Recorder:
    """Closed spans, the last :data:`SPAN_CAP` of them (``dropped`` counts
    the older ones let go), set-up spans (``setup``: a graph's capture,
    once a pattern) kept whole beside them, each name's total nanoseconds
    over every span (none dropped), and counters.  Safe to use from several
    threads."""

    def __init__(self, cap: int = SPAN_CAP):
        self._lock = threading.Lock()
        self._spans: collections.deque[Span] = collections.deque(maxlen=cap)
        self._setup: list[Span] = []
        self._ns: collections.Counter = collections.Counter()
        self._counts: collections.Counter = collections.Counter()
        self.dropped = 0

    def add(self, s: Span, setup: bool = False) -> None:
        with self._lock:
            self._ns[s.name] += s.end_ns - s.start_ns
            if setup:
                self._setup.append(s)
                return
            if len(self._spans) == self._spans.maxlen:
                self.dropped += 1
            self._spans.append(s)

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def spans(self, since_ns: int = 0) -> list[Span]:
        """The spans kept that started at ``since_ns`` or later, by start."""
        with self._lock:
            out = [s for s in (*self._setup, *self._spans) if s.start_ns >= since_ns]
        return sorted(out, key=lambda s: s.start_ns)

    def totals(self) -> dict[str, int]:
        """Nanoseconds by span name, summed over every span recorded."""
        with self._lock:
            return dict(self._ns)

    def counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def write(self, path: str | Path, since_ns: int = 0) -> Path:
        """The spans since ``since_ns`` as a Chrome trace (``ph: "X"``, µs
        since the Unix epoch, the clock of a ``torch.profiler`` trace's
        ``ts`` plus its ``baseTimeNanoseconds``), with the counters and the
        dropped count under ``otherData``."""
        pid = os.getpid()
        events = [{"name": s.name, "ph": "X", "cat": "span", "pid": pid, "tid": s.thread,
                   "ts": s.start_ns / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3, "args": s.ids}
                  for s in self.spans(since_ns)]
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({
            "traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"counters": self.counters(), "dropped": self.dropped}}))
        return path


RECORDER = Recorder()
_recording = False  # span() and count() record; the one read they make while off


def set_recording(on: bool) -> None:
    global _recording
    _recording = bool(on)


def span(name: str, setup: bool = False, **ids):
    """A context manager that records ``name`` with ``ids`` into
    :data:`RECORDER` while the recorder is on (``setup``: whether or not),
    and opens a ``record_function`` range of the same name where a profiler
    runs on this thread.  Never keep one open across a ``yield``."""
    if not (_recording or setup):
        return _NO_SPAN
    return _OpenSpan(RECORDER, name, ids, setup)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the recorder is on."""
    if _recording:
        RECORDER.count(name, n)


def since(now: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    """What :meth:`Recorder.totals` or :meth:`Recorder.counters` added
    between the reading ``before`` and the reading ``now``."""
    return {name: v - before.get(name, 0) for name, v in now.items()}


def per_step_ms(totals: dict[str, int], steps: int) -> dict[str, float]:
    """Milliseconds a step over ``steps`` steps of span ``totals`` (ns by
    name: :meth:`Recorder.totals`, or a run's or an epoch's part of them by
    :func:`since`): ``loader_wait_ms`` (``loader.first_wait`` and
    ``loader.wait``), ``gather_ms`` (``loader.gather``: the worker's busy
    time), ``dispatch_host_ms`` (``dispatch`` less its replay and any
    capture: stacking, the draws and host values, launching eager steps)
    and ``replay_launch_ms`` (``dispatch.replay``), each where its spans
    occurred."""
    ms = {name: ns / 1e6 / max(steps, 1) for name, ns in totals.items()}
    out = {}
    if "loader.wait" in ms or "loader.first_wait" in ms:
        out["loader_wait_ms"] = ms.get("loader.wait", 0.0) + ms.get("loader.first_wait", 0.0)
    if "loader.gather" in ms:
        out["gather_ms"] = ms["loader.gather"]
    if "dispatch" in ms:
        out["dispatch_host_ms"] = ms["dispatch"] - ms.get("dispatch.replay", 0.0) - ms.get(
            "graph.capture", 0.0)
    if "dispatch.replay" in ms:
        out["replay_launch_ms"] = ms["dispatch.replay"]
    return out

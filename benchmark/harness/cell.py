"""One run of a training cell: set-up, the measured window, the metrics,
the correctness check and the result line.

Set-up builds one training object (the port's FCMAE, its AdamW and its
``Dispatcher``), loads the cell's weights, makes or opens the cell's input
and drives the object through its first dispatch: k steps on k distinct
batches, the graph's capture and its first replay.  The norms that the
correctness check compares are read from that state.  The same object and
the same feed then run the window: whole dispatches until ``--seconds``
have passed, closed by one device sync, with at most two dispatches in
flight.  A traced run then traces a few more dispatches.  Once the window
has closed and the memory peak has been read, the program's state is freed
and the reference follows the first k steps.
"""
from __future__ import annotations

import gc
import itertools
import sys
import time
from contextlib import nullcontext

import torch

from . import compare, data, program, trace
from .weights import make_weights
from .spec import Cell, roofline_operations

FORBIDDEN = ("jax", "jaxlib", "flax", "mmearth_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run must not load,
    compared whole (``mmearth_tpu_torch`` is not ``mmearth_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Feed:
    """The iterator handed to ``Dispatcher.run``, with a span around each
    ``next()``: the host's wait for a batch."""

    def __init__(self, batches, annotate: bool):
        self.it, self.annotate = iter(batches), annotate
        self.wait_s = 0.0

    def __iter__(self):
        return self

    def __next__(self):
        ctx = torch.profiler.record_function("bench.input") if self.annotate else nullcontext()
        t0 = time.perf_counter()
        with ctx:
            batch = next(self.it)
        self.wait_s += time.perf_counter() - t0
        return batch


class Window:
    """Whole dispatches from ``dispatches`` with at most two in flight."""

    def __init__(self, dispatches, device):
        self.dispatches, self.device = dispatches, device
        self.losses: list[torch.Tensor] = []
        self.done = None

    def run(self, seconds: float, t0: float) -> int:
        """Dispatch until ``seconds`` have passed since ``t0``; returns the
        dispatches run."""
        n = 0
        while True:
            losses = next(self.dispatches)
            ev = torch.cuda.Event() if self.device.type == "cuda" else None
            if ev is not None:
                ev.record()
            self.losses.append(losses)
            if self.done is not None:
                self.done.synchronize()
            self.done = ev
            n += 1
            if time.perf_counter() - t0 >= seconds:
                return n


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def card_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.splitlines()[0] if out else "unknown"


def make_feed(cell: Cell, seed: int, batch: int, device, annotate: bool):
    """(the Feed, the first dispatch's batches as the reference reads them
    (or a callable that reads them), what the feed holds: the pool's
    batches or the pack's bytes)."""
    traffic, tile = cell.traffic, cell.config["model"]["tile"]
    k = traffic["steps_per_dispatch"]
    if traffic["kind"] == "resident":
        pool = data.device_pool(traffic["pool_batches"], batch, tile, seed, device)
        return Feed(itertools.cycle(pool), annotate), pool[:k], len(pool)
    if traffic["kind"] == "fed":
        from . import feed as fed

        return fed.make(cell, seed, batch, device, annotate)
    raise ValueError(f"unknown traffic kind {traffic['kind']!r}")


class RunContext:
    """What a metric reader reads: the cell, the window's counts, the trace
    (traced runs), the device's peaks and the roofline operations."""

    def __init__(self, cell: Cell, counts: dict, tr, device_info: dict):
        self.cell, self.counts, self.trace, self.device = cell, counts, tr, device_info
        self.batch = cell.traffic["batch"]
        self._ops = None

    @property
    def operations(self) -> dict:
        if self._ops is None:
            self._ops = roofline_operations()
        return self._ops


class Started:
    """The training object after its first dispatch, with what the
    correctness check reads from it (``prog``: the k losses and the per-leaf
    norms) and the inputs the reference takes."""

    def __init__(self, cell: Cell, seed: int, device, annotate: bool):
        cfg, traffic = cell.config, cell.traffic
        self.batch, self.k = traffic["batch"], traffic["steps_per_dispatch"]
        self.seed = seed % 2 ** 63
        self.phases: dict[str, float] = {}  # set-up's seconds by phase, for the log
        t = time.perf_counter()

        def phase(name: str) -> None:
            nonlocal t
            sync(device)
            now = time.perf_counter()
            self.phases[name] = now - t
            t = now

        if device.type == "cuda":
            program.build_kernels()
        phase("kernels")
        self.model, shapes = program.build(cfg, self.batch, device)
        self.weights = make_weights(shapes, self.seed * 3 + 1, device)
        program.load_weights(self.model, self.weights)
        self.opt = program.optimizer(self.model, cfg["optim"])
        self.disp = program.dispatcher(self.model, self.opt, self.k, self.seed, device)
        phase("model")
        self.feed, self.first_batches, self.feed_info = make_feed(
            cell, self.seed, self.batch, device, annotate)
        phase("feed")
        self.base = torch.cuda.memory_allocated(device) if device.type == "cuda" else 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        self.dispatches = self.disp.run(self.feed, 0)
        first = next(self.dispatches)
        phase("first_dispatch")
        self.prog = {"losses": [float(v) for v in first.tolist()],
                     **program.state_norms(self.model, self.opt, self.weights)}

    def free(self, device) -> None:
        """Drop the program's state (the reference runs after it)."""
        for name in ("dispatches", "disp", "opt", "model", "feed"):
            setattr(self, name, None)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def reference_numbers(cell: Cell, st: Started, variants: dict | None = None,
                      detail: bool = False):
    """The reference's k steps from ``st``'s weights and batches, and the
    program's compared numbers against them.  ``variants`` (name -> the
    arguments of :func:`reference.step.train` for a run put in the
    program's place: ``pr``, ``rows``, ``keep_state``) adds each such run's
    numbers under its name; ``detail`` the program's worst leaves and each
    variant's norms.  Returns (numbers by name, the reference's
    :func:`compare.summary`)."""
    from reference.model import Shape
    from reference.step import no_tf32, train

    from .compare import summary

    no_tf32()
    cfg = cell.config
    batches = st.first_batches() if callable(st.first_batches) else st.first_batches
    args = (st.weights, batches, st.seed, cfg["model"]["tile"], Shape(cfg["model"]),
            cfg["optim"])
    ref = summary(train(*args), st.weights)
    out = {"program": compare.numbers(st.prog, ref)}
    if detail:
        out["program_leaves"] = compare.worst_leaves(st.prog, ref)
    for name, kw in (variants or {}).items():
        bad = summary(train(*args, **kw), st.weights)
        out[name] = compare.numbers(bad, ref)
        if detail:
            out[name + "_norms"] = bad
    return out, ref


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        log=print) -> tuple[dict, dict]:
    """One run; returns the result line's object and the window's counts
    (with ``forbidden``, what the process loaded that it must not)."""
    device = torch.device(device)
    traffic = cell.traffic
    st = Started(cell, seed, device, traced)
    k, batch, feed, dispatches = st.k, st.batch, st.feed, st.dispatches
    setup_s = time.perf_counter() - t_start
    phases = {"start": setup_s - sum(st.phases.values()), **st.phases}
    log(f"set-up {setup_s:.3f} s ({', '.join(f'{k} {v:.3f}' for k, v in phases.items())}); "
        f"first dispatch losses {st.prog['losses']}")

    window = Window(dispatches, device)
    feed.wait_s = 0.0
    t0 = time.perf_counter()
    window.run(seconds, t0)
    sync(device)
    wall = time.perf_counter() - t0
    n = len(window.losses)
    counts = {"window_s": wall, "dispatches": n, "steps": n * k, "samples": n * k * batch,
              "input_wait_s": feed.wait_s, "setup_s": setup_s, "feed": st.feed_info}
    tr = None
    if traced:
        # a traced part after the window, timed from inside the profiler
        traced_n = []
        tr = trace.capture(
            lambda: traced_n.append(window.run(traffic["trace_seconds"], time.perf_counter())),
            cell.bench_dir / "cache" / "trace" / "window.json", device)
        counts["traced_dispatches"] = traced_n[0]
        counts["traced_steps"] = traced_n[0] * k
    losses = torch.cat(window.losses).float().cpu()
    counts["failed_steps"] = int((~torch.isfinite(losses)).sum())
    counts["last_loss"] = float(losses[-1])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    counts["peak_bytes"] = peak - st.base
    found_forbidden = forbidden_modules()

    del dispatches, window, feed
    st.free(device)
    t_ref = time.perf_counter()
    found, ref = reference_numbers(cell, st)
    found = found["program"]
    log(f"reference {time.perf_counter() - t_ref:.3f} s; its losses {ref['losses']}")

    info = {**card_info(device), "memory_peak_bytes": peak}
    if traced:
        info.update(busy_s=tr.busy_s, window_s=tr.window_s)
    ctx = RunContext(cell, counts, tr, info)
    metrics = {}
    for m in cell.metrics(traced):
        value = setup_s if m["name"] == "setup_s" else cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": compare.judge(found, cell.limits) and not found_forbidden,
           "attempted": len(losses), "failed": counts["failed_steps"],
           "metrics": metrics, "device": info}
    if traced:
        out["breakdown"] = {"device_ops": trace.top(tr.by_group()),
                            "idle_gaps": trace.top(tr.idle_gaps())}
    out["checks"] = compare.report(found, cell.limits)
    counts["forbidden"] = found_forbidden
    counts["found"] = found
    return out, counts

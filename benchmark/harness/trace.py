"""A ``torch.profiler`` trace of some of the window's dispatches, and its
reduction to device busy time, kernel time by name and group, and idle gaps
named by what the host was doing.

The traced dispatches run inside one ``record_function`` range,
:data:`WINDOW`, that opens after a device sync and closes after another, so
every device operation they enqueue lies inside it.  Its length on the
trace's clock is the traced window.
"""
from __future__ import annotations

import bisect
import collections
import json
from pathlib import Path

from . import groups

WINDOW = "bench.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Trace:
    """Device and host events of a traced window, in microseconds."""

    def __init__(self, events: list[dict]):
        win = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
        if not win:
            raise ValueError(f"the trace holds no {WINDOW!r} range")
        self.start = float(win[0]["ts"])
        self.end = self.start + float(win[0]["dur"])
        self.device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                             for e in events if e.get("cat") in DEVICE_CATS
                             and float(e["ts"]) < self.end
                             and float(e["ts"]) + float(e["dur"]) > self.start)
        self.host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                           for e in events if e.get("cat") in HOST_CATS and e["name"] != WINDOW)

    @classmethod
    def load(cls, path: str | Path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls([e for e in data["traceEvents"] if e.get("ph") == "X" and "dur" in e])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device's operations, clipped to the window."""
        out: list[list[float]] = []
        for s, e, _ in self.device:
            s, e = max(s, self.start), min(e, self.end)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def seconds_where(self, frags_list) -> float:
        """Device seconds of the operations whose name matches any of
        ``frags_list`` (each a fragment or a tuple that must all match)."""
        return sum(e - s for s, e, name in self.device
                   if any(groups.matches(name, f) for f in frags_list)) / 1e6

    def by_group(self) -> dict[str, float]:
        out = collections.Counter()
        for s, e, name in self.device:
            out[groups.group_of(name)] += (e - s) / 1e6
        return dict(out)

    def idle_gaps(self) -> dict[str, float]:
        """Device idle time in the window, summed by the innermost host
        operation running when each gap began ("host between operations"
        where none was)."""
        starts = [h[0] for h in self.host]
        out = collections.Counter()
        prev = self.start
        for s, e in self.busy_intervals() + [(self.end, self.end)]:
            if s > prev:
                out[self._host_at(prev, starts)] += (s - prev) / 1e6
            prev = max(prev, e)
        return dict(out)

    def _host_at(self, t: float, starts: list[float]) -> str:
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(i - 200, -1), -1):
            s, e, name = self.host[j]
            if e > t:
                return name
        return "host between operations"


def top(d: dict[str, float], n: int = 10) -> list[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def capture(run, path: str | Path, device) -> Trace:
    """Run ``run()`` under the profiler (host and device), inside the
    :data:`WINDOW` range between two device syncs; write the Chrome trace
    to ``path`` and read it back."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync = (lambda: torch.cuda.synchronize(device)) if len(acts) > 1 else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run()
            sync()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return Trace.load(path)

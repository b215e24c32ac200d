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
"""
from __future__ import annotations

import collections
import json
import time
from contextlib import contextmanager
from pathlib import Path

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

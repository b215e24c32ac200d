"""The program's own spans, as the ``program_span`` metrics read them: the
recorder of ``mmearth_tpu_torch/utils/profiling.py`` (``RECORDER``), whose
spans carry ``name``, ``start_ns`` and ``end_ns`` on the profiler's clock.

The traced part runs from the first dispatch's start (its ``dispatch.input``,
the pull of its batches, opens just before its ``dispatch`` span) to the
last ``dispatch`` span's end: the program records a dispatch only while a
profiler runs on the dispatching thread, which in a run of the benchmark
is the traced part alone.  A program without the recorder, or a part without the spans a
metric reads, gives None.
"""
from __future__ import annotations


def recorded() -> list | None:
    """Every span the program's recorder holds, or None where it has none."""
    try:
        from mmearth_tpu_torch.utils import profiling
    except ImportError:
        return None
    rec = getattr(profiling, "RECORDER", None)
    return None if rec is None else rec.spans()


def traced_part(spans: list) -> tuple[int, int] | None:
    ends = [s.end_ns for s in spans if s.name == "dispatch"]
    if not ends:
        return None
    return min(s.start_ns for s in spans if s.name in ("dispatch", "dispatch.input")), max(ends)


def seconds(spans: list, names: tuple[str, ...], part: tuple[int, int]) -> float:
    """The seconds of the spans named ``names`` inside ``part``."""
    lo, hi = part
    return sum(max(0, min(s.end_ns, hi) - max(s.start_ns, lo))
               for s in spans if s.name in names) / 1e9


def ms_per_step(ctx, names: tuple[str, ...], less: tuple[str, ...] = (),
                needs: tuple[str, ...] | None = None) -> float | None:
    """Milliseconds a traced step of the spans ``names`` in the traced part,
    less those of ``less``; None where no span of ``needs`` (by default
    ``names``) lies in it."""
    spans = recorded()
    part = traced_part(spans) if spans else None
    if part is None or seconds(spans, needs or names, part) <= 0:
        return None
    spent = seconds(spans, names, part) - seconds(spans, less, part)
    return 1e3 * spent / ctx.counts["traced_steps"]

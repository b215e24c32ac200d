"""Metric logging: stdout meters and TensorBoard (port of
``mmearth_tpu/utils/logging.py``; the reference's SmoothedValue /
MetricLogger / TensorboardLogger, helpers.py:48-289).

The drivers read values off the device only at their print cadence and at
the end of an epoch, and hand the meters host floats.  ``tensorboardX`` is
imported when a writer is made, so the port imports where it is missing;
``wandb`` when ``--wandb True`` asks for it (:func:`maybe_wandb`).
"""
from __future__ import annotations

import datetime
import time
from collections import defaultdict
from typing import Mapping


class Meter:
    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.value = 0.0

    def update(self, v: float, n: int = 1):
        self.value = v
        self.total += v * n
        self.count += n

    @property
    def avg(self):
        return self.total / max(self.count, 1)


class MetricLogger:
    """Meters printed every ``print_freq`` items (not at all without
    ``verbose``: the ranks but the first of a process group)."""

    def __init__(self, print_freq: int = 20, header: str = "", verbose: bool = True):
        self.meters = defaultdict(Meter)
        self.print_freq = print_freq
        self.header = header
        self.verbose = verbose

    def update(self, n: int = 1, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v), n)

    def log_every(self, iterable, total: int | None = None):
        """Yields ``(i, item)``; prints the meters every ``print_freq`` items
        and at the last."""
        total = total if total is not None else len(iterable)
        t0 = time.time()
        for i, item in enumerate(iterable):
            yield i, item
            if self.verbose and (i % self.print_freq == 0 or i == total - 1):
                now = time.time()
                it_time = (now - t0) / max(i % self.print_freq + 1, 1)
                eta = datetime.timedelta(seconds=int(it_time * (total - i - 1)))
                stats = "  ".join(f"{k}: {m.value:.4f} ({m.avg:.4f})"
                                  for k, m in self.meters.items())
                print(f"{self.header} [{i}/{total}]  eta: {eta}  {stats}  time: {it_time:.4f}s")
                t0 = now

    def averages(self) -> dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}


def require_tensorboardx():
    """``tensorboardX.SummaryWriter``, or an ImportError that names it."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        raise ImportError("--log_dir (TensorBoard logging) needs tensorboardX, which is "
                          "not installed") from e
    return SummaryWriter


class TensorboardWriter:
    """tensorboardX writer with the reference's epoch_1000x step
    (helpers.py:209-232, engine_pretrain.py:105-113)."""

    def __init__(self, log_dir: str):
        self.writer = require_tensorboardx()(logdir=log_dir)

    def log(self, metrics: Mapping[str, float], epoch_frac: float, head: str = "train"):
        step = int(epoch_frac * 1000)
        for k, v in metrics.items():
            self.writer.add_scalar(f"{head}/{k}", v, step)

    def flush(self):
        self.writer.flush()

    def close(self):
        self.writer.close()


def maybe_wandb(enabled: bool, project: str, run_name: str | None, config: dict):
    """The ``wandb`` module after ``wandb.init``, or None: when not
    ``enabled``, or where the package is missing (then training goes on, as
    in the JAX package; the reference calls wandb directly,
    main_pretrain.py:183-197)."""
    if not enabled:
        return None
    try:
        import wandb

        wandb.init(project=project, name=run_name, config=config)
        return wandb
    except ImportError:
        print("wandb not installed; continuing without it")
        return None

"""What one cell is, read from ``BENCHMARK.json`` and the files it names.

A cell (a ``workloads`` entry) names a configuration (``configs`` entry ->
its ``file``) and a traffic mix (``benchmark/traffic/<traffic>.json``).
Its correctness limits are ``benchmark/limits/<cell>.json``.  Each metric
``<name>`` of ``BENCHMARK.json`` that the harness does not take itself is
read by ``benchmark/metrics/<name>.py``; each roofline operation is a file
of ``benchmark/roofline/``.  New cells, mixes, metrics and operations are
new files: nothing here lists them.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / BENCH_DIR.name
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = json.loads((self.root / self.config_entry["file"]).read_text())
        self.traffic = json.loads(
            (self.bench_dir / "traffic" / f"{self.workload['traffic']}.json").read_text())
        self.limits = json.loads((self.bench_dir / "limits" / f"{name}.json").read_text())

    def metrics(self, traced: bool) -> list[dict]:
        """The metrics this cell reports in a run (end-to-end untraced,
        per-layer traced): those without ``workloads`` and those that
        list this cell."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.bench[key] if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        """The module that reads ``metric``: ``benchmark/metrics/<metric>.py``."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        return load_module(path, "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"))


def roofline_operations() -> dict[str, dict]:
    """Every operation of ``benchmark/roofline/``: its ``work`` (from the
    file that defines it) and the kernel-name fragments of every file that
    maps a kernel to it."""
    ops: dict[str, dict] = {}
    for path in sorted((BENCH_DIR / "roofline").glob("*.py")):
        mod = load_module(path, "benchmark_roofline_" + path.stem.replace(".", "_"))
        op = ops.setdefault(mod.OPERATION, {"work": None, "kernels": []})
        if getattr(mod, "work", None) is not None:
            op["work"] = mod.work
        op["kernels"].extend(mod.KERNELS)
    return ops

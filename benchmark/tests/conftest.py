"""The benchmark's tests: run from the checkout's root with
``python3 -m pytest benchmark/tests -q``; ``-m gpu`` on a card."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The card, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def tiny_root(tmp: Path, traffic: dict, dtype: str = "float32", limits: dict | None = None,
              config: str = "atto56") -> Path:
    """A checkout-like directory whose ``BENCHMARK.json`` has one cell,
    ``tiny.cell``: the ``config`` at a tiny width and depth, the given
    traffic and limits, and the real metric readers."""
    b = tmp / "benchmark"
    for d in ("configs", "traffic", "limits"):
        (b / d).mkdir(parents=True, exist_ok=True)
    if not (b / "metrics").exists():
        (b / "metrics").symlink_to(BENCH_DIR / "metrics")
    cfg = json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text())
    cfg["model"].update(depths=[1, 1, 2, 1], dims=[16, 16, 16, 32], decoder_embed_dim=32,
                        dtype=dtype)
    (b / "configs/tiny.json").write_text(json.dumps(cfg))
    (b / "traffic/tiny.json").write_text(json.dumps(traffic))
    (b / "limits/tiny.cell.json").write_text(json.dumps(
        limits or {"loss_gap": 1e-4, "moment_gap": 1e-3, "change_gap": 1e-3,
                   "change_median_gap": 1e-3}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": "tiny.cell", "config": "tiny", "traffic": "tiny", "chips": 1,
                           "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.cell"]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


RESIDENT = {"kind": "resident", "batch": 4, "steps_per_dispatch": 2, "pool_batches": 3,
            "trace_seconds": 0.1}
FED = {"kind": "fed", "batch": 4, "steps_per_dispatch": 2, "pack_samples": 16, "pack_seed": 5,
       "num_workers": 2, "trace_seconds": 0.1}


@pytest.fixture
def make_root(tmp_path):
    """``make_root(traffic, dtype=..., limits=...)``: :func:`tiny_root` in
    this test's temporary directory."""
    return lambda traffic, **kw: tiny_root(tmp_path, traffic, **kw)

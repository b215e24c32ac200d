"""The harness's discovery and its result line, on the CPU through the
device argument at a tiny size; and run.py's refusal to measure without a
card."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from conftest import BENCH_DIR, FED, RESIDENT, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run_cell(root, traced: bool, seed: int = 2 ** 33 + 5):
    from harness import cell as runner
    from harness.spec import Cell

    return runner.run(Cell("tiny.cell", root), seed, 0.5, traced, "cpu", time.perf_counter(),
                      lambda msg: None)


@pytest.mark.parametrize("traffic", [RESIDENT, FED], ids=["resident", "fed"])
def test_last_line_keys_and_metrics(make_root, traffic):
    root = make_root(traffic)
    out, counts = run_cell(root, False)
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 2
    bench = json.loads((root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if "tiny.cell" in m.get("workloads",
                                                                           ["tiny.cell"])}
    assert set(out["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["checks"]) == {"loss_gap", "moment_gap", "change_gap", "change_median_gap"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    assert counts["forbidden"] == []


def test_traced_line_has_breakdown(make_root):
    out, counts = run_cell(make_root(RESIDENT), True)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0 and "busy_s" in out["device"]
    # nothing ran on a device: the device's shares are left out, not given as 0
    assert "device_idle.resident" not in out["metrics"]
    assert "dwconv7_roofline" not in out["metrics"]


def test_same_seed_same_first_steps(make_root):
    root = make_root(RESIDENT)
    a, ca = run_cell(root, False, seed=77)
    b, cb = run_cell(root, False, seed=77)
    assert ca["found"] == cb["found"]


def test_every_metric_has_its_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    from harness.spec import Cell

    for w in bench["workloads"]:
        cell = Cell(w["name"])
        for traced in (False, True):
            for m in cell.metrics(traced):
                if m["name"] != "setup_s":
                    mod = cell.reader(m["name"])
                    assert mod.DECLARES["unit"] == m["unit"]
                    assert mod.DECLARES["source"] == m["source"]
                    for key in ("layer", "moves"):
                        if key in m:
                            assert mod.DECLARES[key] == m[key], (m["name"], key)


def test_run_py_refuses_without_a_card(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    cmd = [sys.executable, "benchmark/run.py", "--workload", "atto56.pretrain.resident",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    # a directory that holds only the benchmark's files gives no result either
    only = tmp_path / "only"
    shutil.copytree(BENCH_DIR, only / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", only / "BENCHMARK.json")
    p = subprocess.run(cmd, cwd=only, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""

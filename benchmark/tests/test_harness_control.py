"""The comparison that decides ``correct`` fails what it must: the faults a
training cell can have on one card, planted in the program underneath a
whole run (on the CPU, the card's look skipped), and the control, the
reference in float8 put in the program's place."""
from __future__ import annotations

import json
import time

import pytest
import torch

from conftest import BENCH_DIR, RESIDENT, ROOT


def run_cell(root):
    from harness import cell as runner
    from harness.spec import Cell

    return runner.run(Cell("tiny.cell", root), 31337, 0.3, False, "cpu", time.perf_counter(),
                      lambda msg: None)[0]


def test_sound_run_is_correct(make_root):
    assert run_cell(make_root(RESIDENT))["correct"] is True


def test_state_left_unchanged_is_not_correct(make_root, monkeypatch):
    from mmearth_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "update", lambda self, hyper, mini, applies: None)
    out = run_cell(make_root(RESIDENT))
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_left_out_is_not_correct(make_root, monkeypatch):
    from mmearth_tpu_torch.train import step as step_mod

    real = step_mod._step

    def half(model, opt, batch, draws, mask, loss_sum, update):
        n = batch["sentinel2"].shape[0] // 2
        cut = step_mod.Draws(*(None if d is None else d[:n] for d in draws))
        return real(model, opt, {k: v[:n] for k, v in batch.items()}, cut, mask, loss_sum,
                    update)

    monkeypatch.setattr(step_mod, "_step", half)
    out = run_cell(make_root(RESIDENT))
    assert out["correct"] is False


def test_loss_altered_where_produced_is_not_correct(make_root, monkeypatch):
    from mmearth_tpu_torch.models import fcmae

    real = fcmae.FCMAE.forward_loss

    def off(self, targets, preds, mask):
        loss, *rest = real(self, targets, preds, mask)
        return (loss * 1.01, *rest)

    monkeypatch.setattr(fcmae.FCMAE, "forward_loss", off)
    assert run_cell(make_root(RESIDENT))["correct"] is False


def control_readings(cell, seeds, device):
    from harness.cell import Started, reference_numbers
    from reference.precision import Precision

    out = []
    for seed in seeds:
        st = Started(cell, seed, device, False)
        st.free(device)
        found, _ = reference_numbers(cell, st, {"control": {"pr": Precision("fp8")}})
        out.append(found)
    return out


def test_fp8_control_fails_tiny(make_root):
    from harness.compare import judge
    from harness.spec import Cell

    cell = Cell("tiny.cell", make_root(RESIDENT, dtype="float32"))
    for found in control_readings(cell, (1, 2, 3), torch.device("cpu")):
        assert judge(found["program"], cell.limits)
        assert not judge(found["control"], cell.limits), found["control"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_fp8_control_fails_on_the_card(card, workload, tmp_path):
    """Each cell's own configuration and limits, at a batch of 64, three
    seeds: the control reads past a limit on every seed."""
    from harness.compare import judge
    from harness.spec import Cell

    cell = Cell(workload)
    cell.traffic = dict(cell.traffic, batch=64)
    if cell.traffic["kind"] == "fed":
        cell.bench_dir = tmp_path / "benchmark"
        cell.traffic["pack_samples"] = 1024
    for found in control_readings(cell, (11, 12, 13), card):
        assert not judge(found["control"], cell.limits), found["control"]

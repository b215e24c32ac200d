"""The reference against the port at a tiny size on the CPU (float32, where
both should agree to rounding), and its FLOP count."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import BENCH_DIR, FED, RESIDENT


@pytest.mark.parametrize("traffic", [RESIDENT, FED], ids=["resident", "fed"])
def test_reference_follows_the_port(make_root, traffic):
    """The port's first dispatch (its plain versions on the CPU, f32) and the
    reference's steps from the same weights, draws and rows: losses within
    1e-5 relative, and every leaf's first moment and change within 1e-4 of
    the reference's norm (float32 reassociation over two steps)."""
    from harness.cell import Started, reference_numbers
    from harness.spec import Cell

    cell = Cell("tiny.cell", make_root(traffic))
    dev = torch.device("cpu")
    st = Started(cell, 2 ** 40 + 3, dev, False)
    st.free(dev)
    found, ref = reference_numbers(cell, st)
    p = found["program"]
    assert p["loss_gap"] < 1e-5 and max(p["moment_gap"], p["change_gap"]) < 1e-4, p
    assert all(v == v for v in ref["losses"])


@pytest.mark.parametrize("name", ["atto56", "tiny112"])
def test_flops_per_sample_held(name):
    """The reference's count is the configuration's, and the program's own
    count (``utils/flops.py``: 2.468 and 13.698 GFLOP/sample)."""
    from reference.flops import flops_per_sample

    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    mine = flops_per_sample(cfg["model"])
    assert mine == cfg["flops_per_sample"]
    from mmearth_tpu_torch.utils.flops import pretrain_step_flops

    m = cfg["model"]
    assert pretrain_step_flops(m["model"], m["img_size"], m["patch_size"], 2) / 2 == mine
    assert round(mine / 1e9, 3) == {"atto56": 2.468, "tiny112": 13.698}[name]


def test_weights_follow_the_init_rules():
    from harness.weights import init_kind, make_weights

    shapes = {"encoder.stages.0.0.pwconv1.weight": (160, 40), "encoder.stages.0.0.grn.gamma":
              (1, 1, 1, 160), "encoder.initial_conv.0.weight": (40, 12, 3, 3),
              "encoder.stem.1.weight": (40,), "pred_dict.biome.weight": (14, 512),
              "pred_dict.sentinel2.weight": (768, 512, 1, 1), "proj.bias": (512,)}
    kinds = {k: init_kind(k, s) for k, s in shapes.items()}
    assert kinds == {"encoder.stages.0.0.pwconv1.weight": "trunc1",
                     "encoder.stages.0.0.grn.gamma": "zeros",
                     "encoder.initial_conv.0.weight": "normal02",
                     "encoder.stem.1.weight": "ones", "pred_dict.biome.weight": "normal02",
                     "pred_dict.sentinel2.weight": "trunc1", "proj.bias": "zeros"}
    w = make_weights({"a.pwconv1.weight": (4000, 100)} | {"encoder.stages.0.0.dwconv.weight":
                                                          (400, 1, 7, 7)}, 9, "cpu")
    t = w["encoder.stages.0.0.dwconv.weight"]
    assert abs(float(t.std()) - 1.0) < 0.02 and float(t.abs().max()) <= 2 / 0.8796 + 1e-4
    assert abs(float(w["a.pwconv1.weight"].std()) - 0.02) < 0.001

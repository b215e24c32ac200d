"""The port's bench (``scripts/torch_bench.py``) and convergence gate
(``scripts/torch_convergence_gate.py``) on the CPU at a toy size: the last
line is one JSON object with the metric's keys, what is not ported raises,
no card raises, a drop below the bar fails the gate with exit code 1, and
the synthetic batch is ``__graft_entry__._synthetic_batch``'s."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from mmearth_tpu_torch.data.synthetic import bench_batch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import torch_bench as tb  # noqa: E402
import torch_convergence_gate as gate  # noqa: E402

TOY = ["--device", "cpu", "--batch_size", "4", "--rounds", "1", "--steps", "2"]
LINE_KEYS = {"metric", "value", "unit", "ms_per_step", "round_ms_per_step", "peak_mem_gib",
             "batch", "rounds", "steps", "device", "card"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith("{") and "\n" not in lines[-1]
    return json.loads(lines[-1])


@pytest.mark.parametrize("n,tile,seed", [(3, 64, 0), (2, 120, 7)])
def test_bench_batch_is_the_graft_entry_batch(n, tile, seed):
    ours, ref = bench_batch(n, tile, seed), _synthetic_batch(n, tile, seed)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("config,metric,extra", [
    ("atto56", "mpmae_atto_mmearth64_pretrain_samples_per_sec_per_chip",
     {"block_impl", "auto_value", "auto_ms_per_step", "auto_round_ms_per_step",
      "auto_peak_mem_gib", "eager_value", "eager_ms_per_step", "eager_round_ms_per_step",
      "eager_peak_mem_gib", "capture_s"}),
    ("finetune", "geobench_cls_finetune_atto112_img_per_sec_per_chip", set()),
])
def test_bench_on_cpu_prints_one_json_line_last(capsys, config, metric, extra):
    assert tb.main(["--config", config, *TOY]) == 0
    line = _last_line(capsys)
    assert line["metric"] == metric and set(line) == LINE_KEYS | extra
    assert line["value"] > 0 and line["ms_per_step"] > 0
    assert line["value"] == pytest.approx(4e3 / line["ms_per_step"])
    assert [line["ms_per_step"]] == line["round_ms_per_step"]
    assert (line["device"], line["card"], line["peak_mem_gib"]) == ("cpu", "cpu", None)
    if config == "atto56":
        assert line["block_impl"] == "wholeblock" and line["auto_value"] > 0
        assert line["eager_value"] > 0 and len(line["eager_round_ms_per_step"]) == 1
        assert line["capture_s"] is None  # nothing is captured on the CPU


def test_bench_mmpack_on_cpu(tmp_path):
    """The step fed from disk: the train split of a small pack, one warm-up
    epoch and one timed."""
    out = tb.bench_mmpack(torch.device("cpu"), batch=4, n_samples=24, epochs=2,
                          pack_dir=tmp_path / "pack")
    assert out["pack_samples"] == 21 and out["epochs_timed"] == 1
    assert out["value"] > 0 and out["loader_only_host_sps"] > 0
    assert out["h2d_mbytes_per_sec"] is None and out["input"] == "mmpack"
    assert out["sample_mbytes"] == pytest.approx(0.429496)


@pytest.mark.parametrize("argv,what", [
    (["--config", "seg"], "U-Net"), (["--input", "grain"], "Grain"),
    (["--input", "hdf5"], "HDF5"),
])
def test_bench_refuses_what_is_not_ported(capsys, argv, what):
    with pytest.raises(NotImplementedError, match=what):
        tb.run(tb.get_args_parser().parse_args([*argv, "--device", "cpu"]))
    assert tb.main([*argv, "--device", "cpu"]) == 1
    line = _last_line(capsys)
    assert line["value"] == 0.0 and line["error"].startswith("NotImplementedError")
    assert what in line["error"]


def test_scripts_refuse_cuda_without_a_card_and_records_from_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.run(tb.get_args_parser().parse_args([]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gate.main([])
    with pytest.raises(ValueError, match="GPU"):
        tb.run(tb.get_args_parser().parse_args([*TOY, "--record"]))
    with pytest.raises(ValueError, match="GPU"):
        gate.main(["--device", "cpu", "--record"])


@pytest.mark.parametrize("drop,sps,bench,failed", [
    (0.49, None, None, ["loss"]), (0.51, None, None, []), (0.83, 95.0, 100.0, []),
    (0.83, 111.0, 100.0, ["samples/s"]), (0.2, 80.0, 100.0, ["loss", "samples/s"]),
    (float("nan"), None, None, ["loss"]),
])
def test_gate_failures(drop, sps, bench, failed):
    got = gate.failures(drop, sps, bench)
    assert len(got) == len(failed) and all(w in g for w, g in zip(failed, got))


def test_gate_on_cpu_prints_passed_last(capsys):
    """Ten synthetic steps at batch 4: the report's keys on the last line,
    ``passed`` as the failures say, and exit code 1 on a failure (a drop
    below 0.50 in ten steps)."""
    rc = gate.main(["--device", "cpu", "--steps", "10", "--batch_size", "4",
                    "--bench_rounds", "1", "--bench_steps", "2"])
    line = _last_line(capsys)
    assert {"passed", "loss_drop", "loss_first5_mean", "loss_last5_mean", "steps",
            "train_mode_sps_per_chip", "bench_sps_per_chip", "failures", "card"} <= set(line)
    assert line["steps"] == 10 and len(line["loss_chunk_means"]) == 2
    assert len(line["chunk_ms_per_step"]) == 1 and len(line["bench_round_ms_per_step"]) == 1
    assert line["loss_drop"] == pytest.approx(
        1 - line["loss_last5_mean"] / line["loss_first5_mean"])
    assert line["passed"] == (not line["failures"]) and rc == (0 if line["passed"] else 1)
    assert (line["loss_drop"] >= 0.5) or (rc == 1 and not line["passed"])


def test_gate_mmpack_on_cpu(tmp_path):
    """From disk: 6 steps of batch 4 at 2 a dispatch over a 5-batch epoch
    (two dispatches, the fifth batch a skipped tail), so two epochs."""
    out = gate.gate_mmpack(torch.device("cpu"), steps=6, batch=4, n_samples=24,
                           pack_dir=tmp_path / "pack", k=2)
    assert out["steps"] == 6 and out["epochs_consumed"] == 2 and out["pack_samples"] == 21
    assert out["graphs"][0]["steps"] == {"eager": 6, "recorded": 0, "replayed": 0}
    assert out["sps_through_loader_per_chip"] > 0 and out["h2d_bound_sps"] is None
    assert np.isfinite(out["loss_drop"])

"""The port's metric logging (``mmearth_tpu_torch/utils/logging.py``)
against the JAX package's: the meters' averages and the print cadence, the
TensorBoard tags and epoch x 1000 steps of a ``--log_dir`` run of both
drivers (JAX's ``train/<key>``), and ``--log_dir`` refused, naming
tensorboardX, where it is missing."""
import struct

import numpy as np
import pytest
import torch

pytest.importorskip("tensorboardX")

from mmearth_tpu.utils import logging as jlog  # noqa: E402
from mmearth_tpu_torch import main_finetune, main_pretrain  # noqa: E402
from mmearth_tpu_torch.data import geobench as gb  # noqa: E402
from mmearth_tpu_torch.data.synthetic import generate_packed  # noqa: E402
from mmearth_tpu_torch.models.fcmae import FCMAE  # noqa: E402
from mmearth_tpu_torch.utils import logging as tlog  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_meters_match_jaxs():
    ours, ref = tlog.Meter(), jlog.Meter()
    for v, n in ((1.0, 3), (5.0, 1), (-2.5, 2)):
        ours.update(v, n)
        ref.update(v, n)
    assert (ours.value, ours.avg, ours.count) == (ref.value, ref.avg, ref.count) == (
        -2.5, (3.0 + 5.0 - 5.0) / 6, 6)
    assert tlog.Meter().avg == 0.0


@pytest.mark.parametrize("freq,n", [(2, 5), (3, 7), (20, 3)])
def test_metric_logger_cadence_and_averages_match_jaxs(capsys, freq, n):
    out = {}
    for name, mod in (("ours", tlog), ("jax", jlog)):
        ml = mod.MetricLogger(print_freq=freq, header="Epoch: [0]")
        for i, _ in ml.log_every(range(n)):
            ml.update(loss=float(i), lr=0.1 * i)
        lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("Epoch")]
        out[name] = ([ln.split("eta")[0] for ln in lines], ml.averages())
    assert out["ours"] == out["jax"]
    assert len(out["ours"][0]) == len({*range(0, n, freq), n - 1})
    assert np.isclose(out["ours"][1]["loss"], np.mean(range(n)))


def read_events(log_dir) -> list[tuple[str, int, float]]:
    """(tag, step, value) of every scalar in ``log_dir``'s event files (the
    TFRecord framing: length, its CRC, the Event proto, its CRC)."""
    from tensorboardX.proto import event_pb2

    out = []
    for path in sorted(log_dir.glob("events.out.tfevents.*")):
        data, at = path.read_bytes(), 0
        while at < len(data):
            (length,) = struct.unpack("<Q", data[at:at + 8])
            event = event_pb2.Event.FromString(data[at + 12:at + 12 + length])
            at += 16 + length
            out.extend((v.tag, event.step, v.simple_value) for v in event.summary.value)
    return out


def test_writer_tags_and_steps_match_jaxs(tmp_path):
    for name, mod in (("ours", tlog), ("jax", jlog)):
        tb = mod.TensorboardWriter(str(tmp_path / name))
        tb.log({"loss": 1.5, "lr": 0.25}, epoch_frac=2.25)
        tb.log({"test_acc": 0.5}, 3, head="val")
        tb.writer.close()
    assert read_events(tmp_path / "ours") == read_events(tmp_path / "jax") == [
        ("train/loss", 2250, 1.5), ("train/lr", 2250, 0.25), ("val/test_acc", 3000, 0.5)]


def test_main_pretrain_log_dir_writes_jaxs_tags(tmp_path):
    generate_packed(tmp_path / "data", n=18, tile=64, seed=0, splits=("train",))
    args = main_pretrain.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--batch_size", "4", "--device", "cpu", "--processed_dir", str(tmp_path / "data"),
        "--epochs", "2", "--warmup_epochs", "1", "--use_bf16", "False",
        "--decoder_embed_dim", "64", "--log_dir", str(tmp_path / "tb")])
    _, history, _ = main_pretrain.main(args)
    events = read_events(tmp_path / "tb")
    assert {step for _, step, _ in events} == {1000, 2000}
    tags = {tag for tag, _, _ in events}
    assert {"train/loss", "train/lr", "train/loss_sentinel2", "train/loss_biome"} <= tags
    losses = [v for tag, _, v in events if tag == "train/loss"]
    np.testing.assert_allclose(losses, [e["loss"] for e in history], rtol=1e-6)


def test_main_finetune_log_dir_writes_the_log_stats(tmp_path):
    gb.generate_synthetic_geobench(tmp_path, "m-eurosat", (8, 4, 4))
    fc = FCMAE(img_size=56, patch_size=8, depths=(2, 2, 6, 2), dims=(40, 80, 160, 320))
    torch.save({"model": fc.init_weights(torch.Generator().manual_seed(0)).state_dict()},
               tmp_path / "pt.pth")
    args = main_finetune.get_args_parser().parse_args([
        "--device", "cpu", "--model", "convnextv2_atto", "--input_size", "56",
        "--patch_size", "8", "--processed_dir", str(tmp_path), "--finetune",
        str(tmp_path / "pt.pth"), "--batch_size", "4", "--epochs", "1", "--linear_probe",
        "True", "--log_dir", str(tmp_path / "tb")])
    main_finetune.main(args)
    tags = {(tag, step) for tag, step, _ in read_events(tmp_path / "tb")}
    assert tags == {(f"train/{k}", 1000) for k in ("train_loss", "train_lr", "test_Accuracy",
                                                    "epoch", "n_parameters")}


def test_log_dir_without_tensorboardx_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "tensorboardX", None)
    args = main_pretrain.get_args_parser().parse_args([
        "--device", "cpu", "--processed_dir", str(tmp_path), "--log_dir", str(tmp_path / "tb")])
    with pytest.raises(ImportError, match="tensorboardX"):
        main_pretrain.main(args)
    assert not (tmp_path / "tb").exists()

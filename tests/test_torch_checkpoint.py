"""The port's ``.pth`` checkpoints (``mmearth_tpu_torch/checkpoints/pth_io.py``)
on the CPU: AdamW's state round trip, the file layout and its pruning, a
resumed run of either driver equal bit for bit to an uninterrupted one, the
params-only ``--resume`` (dense and upstream Minkowski), the finetune's
``log.txt`` and ``checkpoint-best.pth``, and JAX's own ``.pth`` resume
(``torch_convert.torch_fcmae_to_flax``) reading a port-saved file."""
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.checkpoints import torch_convert as jtc
from mmearth_tpu.configs import modalities as JM
from mmearth_tpu.models import fcmae as jfc
from mmearth_tpu_torch import main_finetune, main_pretrain
from mmearth_tpu_torch.checkpoints import pth_io
from mmearth_tpu_torch.checkpoints.convert import from_jax_fcmae
from mmearth_tpu_torch.data import geobench as gb
from mmearth_tpu_torch.data.synthetic import bench_batch, generate_packed
from mmearth_tpu_torch.models.fcmae import FCMAE
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train import pretrain

ATTO = ((2, 2, 6, 2), (40, 80, 160, 320))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Killed(Exception):
    pass


def _kill_after_save(monkeypatch, epoch: int):
    """Make the next save of ``epoch`` write its file and then stop the run,
    as a kill right after the checkpoint would."""
    save = pth_io.save_checkpoint

    def save_then_die(output_dir, e, *a, **kw):
        path = save(output_dir, e, *a, **kw)
        if e == epoch:
            raise _Killed(path)
        return path

    monkeypatch.setattr(pth_io, "save_checkpoint", save_then_die)


def _assert_same_checkpoint(a, b, keys=("model", "optimizer", "ema")):
    """Every tensor (and count) of two checkpoint dicts equal bit for bit."""
    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = v
        return out

    fa, fb = (flat({k: x[k] for k in keys if k in x}) for x in (a, b))
    assert set(fa) == set(fb)
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


# ---------------------------------------------------------------------------
# AdamW state
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("update_freq,before", [(1, 3), (2, 4), (2, 3)],
                         ids=["freq1", "freq2", "freq2-mid-accumulation"])
def test_adamw_state_dict_round_trip(update_freq, before):
    """``before`` micro-steps, the state through torch.save/load
    (weights_only) into a fresh AdamW on copies of the params, then both go
    on for 3 micro-steps: params and state stay equal bit for bit."""
    rng = np.random.default_rng(0)
    shapes = {"a.weight": (5, 3), "a.bias": (5,), "b": (2, 2, 2)}
    init = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32)) for k, s in shapes.items()}
    grads = [{k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for k, s in shapes.items()} for _ in range(before + 3)]

    def make():
        params = {k: torch.nn.Parameter(v.clone()) for k, v in init.items()}
        return params, toptim.AdamW(params.items(), lambda c: 1e-2 / (1 + c), 0.05,
                                    update_freq=update_freq, clip_grad=1.0)

    def step(params, opt, g):
        for k, p in params.items():
            p.grad = g[k].clone()
        opt.step()

    pa, oa = make()
    for g in grads[:before]:
        step(pa, oa, g)
    buf = io.BytesIO()
    torch.save(oa.state_dict(), buf)
    buf.seek(0)
    pb, ob = make()
    with torch.no_grad():
        for k in pb:
            pb[k].copy_(pa[k])
    ob.load_state_dict(torch.load(buf, weights_only=True))
    assert (ob.count, ob.mini_step) == (oa.count, oa.mini_step)
    assert oa.mini_step == (before % update_freq)
    for g in grads[before:]:
        step(pa, oa, g)
        step(pb, ob, g)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    _assert_same_checkpoint({"optimizer": oa.state_dict()}, {"optimizer": ob.state_dict()})


def test_adamw_load_refuses_another_layout():
    p = torch.nn.Parameter(torch.zeros(3))
    state = toptim.AdamW([("w", p)], lambda c: 0.1).state_dict()
    with pytest.raises(ValueError, match="acc"):
        toptim.AdamW([("w", p)], lambda c: 0.1, update_freq=2).load_state_dict(state)
    with pytest.raises(ValueError, match="mu"):
        toptim.AdamW([("v", p)], lambda c: 0.1).load_state_dict(state)


# ---------------------------------------------------------------------------
# the file layout
# ---------------------------------------------------------------------------
def _tiny():
    model = torch.nn.Linear(3, 2)
    return model, toptim.AdamW(model.named_parameters(), lambda c: 0.1)


@pytest.mark.parametrize("keep,left", [(2, [3, 4]), (3, [2, 3, 4]), (0, [0, 1, 2, 3, 4])])
def test_save_keeps_the_newest_and_loads_weights_only(tmp_path, keep, left):
    model, opt = _tiny()
    (tmp_path / "checkpoint-best.pth").write_bytes(b"")
    for epoch in range(5):
        pth_io.save_checkpoint(tmp_path, epoch, model, opt, {"lr": 0.1, "betas": [0.9, 0.95]},
                               keep=keep)
    assert [e for e, _ in pth_io.numbered_checkpoints(tmp_path)] == left
    assert (tmp_path / "checkpoint-best.pth").exists()  # not numbered: never pruned
    assert not list(tmp_path.glob("*.tmp"))
    assert pth_io.latest_checkpoint(tmp_path) == tmp_path / "checkpoint-4.pth"
    assert pth_io.resolve(tmp_path) == tmp_path / "checkpoint-4.pth"
    ckpt = torch.load(tmp_path / "checkpoint-4.pth", weights_only=True)
    assert set(ckpt) == {"model", "optimizer", "epoch", "args"}
    assert ckpt["epoch"] == 4 and ckpt["args"] == {"lr": 0.1, "betas": [0.9, 0.95]}


def test_resume_of_a_missing_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        pth_io.resolve(tmp_path)
    with pytest.raises(FileNotFoundError, match="no such file"):
        pth_io.resolve(tmp_path / "x.pth")


# ---------------------------------------------------------------------------
# the pretraining driver
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mmpack(tmp_path_factory):
    # 10 train + 1 val samples of 64-px tiles: 2 steps of batch 4 an epoch
    return generate_packed(tmp_path_factory.mktemp("mmpack"), n=11, tile=64, seed=0)


def _pt_args(data, *extra):
    return main_pretrain.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--batch_size", "4", "--device", "cpu", "--processed_dir", str(data),
        "--warmup_epochs", "1", *extra])


def test_pretrain_resume_is_bit_exact(mmpack, tmp_path, monkeypatch):
    """2 epochs uninterrupted against 1 epoch, a kill after its checkpoint,
    then ``--auto_resume`` for the second: the same step losses, params and
    optimizer state, bit for bit."""
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    model, hist, opt = main_pretrain.main(_pt_args(mmpack, "--epochs", "2",
                                                   "--output_dir", str(whole)))
    with monkeypatch.context() as m:
        _kill_after_save(m, 0)
        with pytest.raises(_Killed):
            main_pretrain.main(_pt_args(mmpack, "--epochs", "2", "--output_dir", str(cut)))
    assert [e for e, _ in pth_io.numbered_checkpoints(cut)] == [0]
    model2, hist2, opt2 = main_pretrain.main(_pt_args(mmpack, "--epochs", "2",
                                                      "--output_dir", str(cut)))
    assert [h["epoch"] for h in hist] == [0, 1] and [h["epoch"] for h in hist2] == [1]
    assert hist2[0]["step_losses"] == hist[1]["step_losses"]
    assert hist2[0]["loss"] == hist[1]["loss"]
    for name in ("checkpoint-0.pth", "checkpoint-1.pth"):
        _assert_same_checkpoint(pth_io.load(whole / name), pth_io.load(cut / name))
    _assert_same_checkpoint({"model": model.state_dict(), "optimizer": opt.state_dict()},
                            {"model": model2.state_dict(), "optimizer": opt2.state_dict()})
    assert opt2.count == 4
    # the file holds the run's flags and its last state
    last = torch.load(cut / "checkpoint-1.pth", weights_only=True)
    assert last["epoch"] == 1 and last["args"]["output_dir"] == str(cut)
    _assert_same_checkpoint(last, {"model": model2.state_dict(), "optimizer": opt2.state_dict()})


@pytest.mark.parametrize("extra,saved", [
    (["--save_ckpt_num", "2"], [1, 2]),
    (["--save_ckpt_freq", "2", "--save_ckpt_num", "0"], [1, 2]),
    (["--save_ckpt", "False"], []),
])
def test_pretrain_saves_by_freq_and_prunes(mmpack, tmp_path, extra, saved):
    """A save where (epoch + 1) % save_ckpt_freq == 0 or on the last epoch,
    the newest save_ckpt_num kept."""
    main_pretrain.main(_pt_args(mmpack, "--epochs", "3", "--output_dir", str(tmp_path), *extra))
    assert [e for e, _ in pth_io.numbered_checkpoints(tmp_path)] == saved


def _minkowski(sd):
    """Upstream's sparse layout of a dense FCMAE state dict: the encoder's
    convs as Minkowski ``*.kernel`` tensors (the inverse of the remap), GRN
    affines (1, C), biases as they are."""
    out = {}
    for k, v in sd.items():
        v = v.numpy()
        if not k.startswith("encoder."):
            out[k] = v
        elif k.endswith(".weight") and v.ndim == 4 and ("dwconv" in k or "stem.0" in k):
            c, _, ks, _ = v.shape
            out[k[:-7] + ".kernel"] = v.swapaxes(3, 2).reshape(c, ks * ks).transpose(1, 0)
        elif k.endswith(".weight") and v.ndim == 4:
            o, i, ks, _ = v.shape
            out[k[:-7] + ".kernel"] = v.swapaxes(3, 2).reshape(o, i, ks * ks).transpose(2, 1, 0)
        elif ".grn." in k:
            out[k] = v.reshape(1, -1)
        else:
            out[k] = v
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("layout", ["dense", "minkowski"])
def test_resume_from_a_model_only_pth_keeps_start_epoch(mmpack, tmp_path, layout):
    """``--resume`` of a file that holds the model alone (the port's or
    upstream's Minkowski layout) restores the params, leaves the optimizer
    fresh and starts at ``--start_epoch``."""
    src = FCMAE(img_size=56, patch_size=8, depths=ATTO[0], dims=ATTO[1])
    src.init_weights(torch.Generator().manual_seed(5))
    sd = src.state_dict()
    torch.save({"model": sd if layout == "dense" else _minkowski(sd)}, tmp_path / "m.pth")
    model, hist, opt = main_pretrain.main(_pt_args(
        mmpack, "--epochs", "2", "--start_epoch", "2", "--resume", str(tmp_path / "m.pth")))
    assert hist == [] and opt.count == 0
    got = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
    _, hist, opt = main_pretrain.main(_pt_args(
        mmpack, "--epochs", "2", "--start_epoch", "1", "--resume", str(tmp_path / "m.pth")))
    assert [h["epoch"] for h in hist] == [1] and opt.count == 2


def test_explicit_resume_takes_a_file_or_a_directory(mmpack, tmp_path):
    """``--resume`` of a run's directory or of its newest file starts after
    that file's epoch, whatever ``--start_epoch`` says."""
    main_pretrain.main(_pt_args(mmpack, "--epochs", "1", "--output_dir", str(tmp_path)))
    for path in (tmp_path, tmp_path / "checkpoint-0.pth"):
        _, hist, opt = main_pretrain.main(_pt_args(
            mmpack, "--epochs", "1", "--start_epoch", "0", "--resume", str(path)))
        assert hist == [] and opt.count == 2


# ---------------------------------------------------------------------------
# the finetune driver
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def geobench(tmp_path_factory):
    """Synthetic packed m-eurosat (12 train, 4 val, 4 test) and a pretraining
    .pth of convnextv2_atto."""
    d = tmp_path_factory.mktemp("geobench")
    gb.generate_synthetic_geobench(d, "m-eurosat", (12, 4, 4))
    fc = FCMAE(img_size=56, patch_size=8, depths=ATTO[0], dims=ATTO[1])
    torch.save({"model": fc.init_weights(torch.Generator().manual_seed(0)).state_dict()},
               d / "pt.pth")
    return d


def _ft_args(d, *extra):
    return main_finetune.get_args_parser().parse_args([
        "--device", "cpu", "--model", "convnextv2_atto", "--input_size", "56",
        "--patch_size", "8", "--processed_dir", str(d), "--finetune", str(d / "pt.pth"),
        "--batch_size", "4", "--epochs", "2", "--blr", "2e-4", "--layer_decay", "0.9",
        "--weight_decay", "0.3", "--drop_path", "0.1", "--smoothing", "0.2",
        "--model_ema", "True", "--model_ema_decay", "0.9", *extra])


@pytest.fixture(scope="module")
def finetuned(geobench, tmp_path_factory):
    """Two uninterrupted finetune epochs with an output directory."""
    out_dir = tmp_path_factory.mktemp("ft_whole")
    return main_finetune.main(_ft_args(geobench, "--output_dir", str(out_dir))), out_dir


def test_finetune_resume_is_bit_exact(geobench, finetuned, tmp_path, monkeypatch):
    """As the pretraining test, with the EMA in the checkpoint: the resumed
    second epoch has the same step losses, val score, log line, params,
    optimizer state and EMA."""
    whole, whole_dir = finetuned
    with monkeypatch.context() as m:
        _kill_after_save(m, 0)
        with pytest.raises(_Killed):
            main_finetune.main(_ft_args(geobench, "--output_dir", str(tmp_path)))
    cut = main_finetune.main(_ft_args(geobench, "--output_dir", str(tmp_path)))
    assert [h["epoch"] for h in cut["history"]] == [1]
    for key in ("step_losses", "val_Accuracy"):
        assert cut["history"][0][key] == whole["history"][1][key]
    for name in ("checkpoint-0.pth", "checkpoint-1.pth"):
        _assert_same_checkpoint(pth_io.load(whole_dir / name), pth_io.load(tmp_path / name))
    _assert_same_checkpoint({"model": whole["model"].state_dict(),
                             "optimizer": whole["optimizer"].state_dict()},
                            {"model": cut["model"].state_dict(),
                             "optimizer": cut["optimizer"].state_dict()})
    logs = [(d / "log.txt").read_text().splitlines() for d in (whole_dir, tmp_path)]
    assert logs[0] == logs[1] and len(logs[0]) == 2
    assert cut["test_Accuracy"] == whole["test_Accuracy"]


def test_finetune_log_best_checkpoint_and_test_from_disk(geobench, finetuned, monkeypatch):
    """log.txt holds the reference's keys an epoch; checkpoint-best.pth the
    params of the best val epoch (the later of ties); the final test scores
    the newest checkpoint reloaded from disk."""
    out, out_dir = finetuned
    lines = [json.loads(x) for x in (out_dir / "log.txt").read_text().splitlines()]
    assert [x["epoch"] for x in lines] == [0, 1]
    for x, h in zip(lines, out["history"]):
        assert set(x) == {"train_loss", "train_lr", "test_Accuracy", "epoch", "n_parameters"}
        assert x["train_loss"] == pytest.approx(h["loss"])
        assert x["test_Accuracy"] == h["val_Accuracy"]
        assert x["n_parameters"] == sum(p.numel() for p in out["model"].parameters())
    vals = [h["val_Accuracy"] for h in out["history"]]
    best = torch.load(out_dir / "checkpoint-best.pth", weights_only=True)
    assert best["epoch"] == max(e for e, v in enumerate(vals) if v == max(vals))
    assert out["best_val_Accuracy"] == max(vals)
    assert out["test_params_from"] == "disk (epoch 1)"
    assert set(torch.load(out_dir / "checkpoint-1.pth", weights_only=True)) == {
        "model", "optimizer", "epoch", "args", "ema"}
    # a resumed run with no epoch left scores the same file again
    loaded = []
    load = pth_io.load
    monkeypatch.setattr(pth_io, "load", lambda p: loaded.append(p) or load(p))
    again = main_finetune.main(_ft_args(geobench, "--output_dir", str(out_dir)))
    assert again["history"] == [] and again["test_params_from"] == "disk (epoch 1)"
    assert again["test_Accuracy"] == out["test_Accuracy"]
    assert loaded[-1] == out_dir / "checkpoint-1.pth"


# ---------------------------------------------------------------------------
# JAX's .pth resume reads the port's files
# ---------------------------------------------------------------------------
def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_port_checkpoint_loads_into_jax_fcmae_tree(mmpack, tmp_path):
    """A flax FCMAE tree (every leaf drawn anew; its structure and shapes
    those of JAX's own init) carried into the port by ``from_jax_fcmae`` as a
    params-only ``--resume``: the port's checkpoint written before any step
    strict-converts (``torch_convert.load_pth`` + ``torch_fcmae_to_flax``)
    back to that tree bit for bit, and the one written after an epoch of
    the driver to the port's trained params."""
    mods = dict(JM.OUT_MODALITIES)
    jm = jfc.convnextv2_atto(img_size=56, patch_size=8, sparse=True, loss_aggr="uncertainty",
                             inp_modalities=JM.INP_MODALITIES, out_modalities=mods)
    sample = {k: jnp.asarray(v) for k, v in bench_batch(2, 56).items()}
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "mask": jax.random.PRNGKey(1)}, sample))["params"]
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32) * 0.1, shapes)
    torch.save({"model": from_jax_fcmae(tree, ATTO[0], list(mods))}, tmp_path / "init.pth")

    def as_flax(path):
        return _leaves(jtc.torch_fcmae_to_flax(jtc.load_pth(path), ATTO[0], mods))

    ref = _leaves(tree)
    # before any step: the restored model saved as a checkpoint
    cfg = main_pretrain.config_from_args(_pt_args(mmpack, "--resume", str(tmp_path / "init.pth")))
    model = pretrain.build_model(cfg, "cpu")
    opt = toptim.AdamW(model.named_parameters(), lambda c: 0.1)
    assert pth_io.restore(tmp_path / "init.pth", model, opt) is None
    got = as_flax(pth_io.save_checkpoint(tmp_path / "zero", 0, model, opt, {}))
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # after an epoch of the driver
    trained, hist, _ = main_pretrain.main(_pt_args(
        mmpack, "--epochs", "1", "--resume", str(tmp_path / "init.pth"),
        "--output_dir", str(tmp_path / "run")))
    got = as_flax(tmp_path / "run" / "checkpoint-0.pth")
    want = _leaves(jtc.torch_fcmae_to_flax({k: v.numpy() for k, v in trained.state_dict().items()},
                                           ATTO[0], mods))
    assert set(got) == set(ref) and hist[0]["steps"] == 2
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert any(not np.array_equal(got[k], ref[k]) for k in ref)

"""The port's pretraining entry point and its boundaries: a CPU run of
``mmearth_tpu_torch.main_pretrain``, the CUDA request without a card, the
import isolation from JAX, and chip_smoke.py's refusal to run without a GPU
or outside the repo."""
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mmearth_tpu_torch import main_pretrain
from mmearth_tpu_torch.data.synthetic import generate_packed
from mmearth_tpu_torch.ops import fused_block, patch_select, wholeblock
from mmearth_tpu_torch.train import pretrain

ROOT = Path(__file__).resolve().parents[1]


def _args(data, *extra):
    return main_pretrain.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--batch_size", "4", "--device", "cpu", "--processed_dir", str(data), "--epochs", "1",
        "--warmup_epochs", "1", *extra])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # 10 train + 1 val samples of 64-px tiles: 2 steps of batch 4 (drop_last)
    return generate_packed(tmp_path_factory.mktemp("mmpack"), n=11, tile=64, seed=0)


def test_main_pretrain_runs_two_steps_on_cpu(data):
    """The atto 56/8 configuration in bf16 on the CPU (the kernels' plain
    versions): finite losses, the exact epoch mean, no kernel launched."""
    before = {**patch_select.LAUNCHES, **wholeblock.LAUNCHES}
    model, history, _ = main_pretrain.main(_args(data))
    assert [e["steps"] for e in history] == [2]
    losses = history[0]["step_losses"]
    assert all(math.isfinite(v) for v in losses)
    assert history[0]["loss"] == pytest.approx(sum(losses) / 2, rel=1e-6)
    assert {**patch_select.LAUNCHES, **wholeblock.LAUNCHES} == before
    assert next(model.parameters()).dtype == torch.float32
    assert model.encoder.stages[0][0].grn.group == 4  # per_device scope = the batch


def test_main_pretrain_masked_dense_fused_runs_two_steps_on_cpu(data):
    """--sparse_impl masked_dense --block_impl fused in bf16 on the CPU: the
    masked-dense encoder with the plain fused_block_mlp in every block,
    finite losses, no kernel launched."""
    launches = lambda: {**patch_select.LAUNCHES, **wholeblock.LAUNCHES, **fused_block.LAUNCHES}
    before = launches()
    model, history, _ = main_pretrain.main(_args(data, "--sparse_impl", "masked_dense",
                                              "--block_impl", "fused"))
    assert [e["steps"] for e in history] == [2]
    assert all(math.isfinite(v) for v in history[0]["step_losses"])
    assert launches() == before
    assert model.encoder.sparse_impl == "masked_dense"
    assert all(blk.fused for stage in model.encoder.stages for blk in stage)


def test_main_pretrain_wholeblock_runs_two_steps_on_cpu(data):
    """--block_impl wholeblock in bf16 on the CPU: the spill-g tail's plain
    version, finite losses, no kernel launched."""
    launches = lambda: {**patch_select.LAUNCHES, **wholeblock.LAUNCHES, **fused_block.LAUNCHES}
    before = launches()
    model, history, _ = main_pretrain.main(_args(data, "--block_impl", "wholeblock"))
    assert [e["steps"] for e in history] == [2]
    assert all(math.isfinite(v) for v in history[0]["step_losses"])
    assert launches() == before
    assert model.encoder.stages[0][0].spillg


def test_cuda_without_a_card_raises(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.resolve_device("cuda")
    args = _args(data)
    args.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main_pretrain.main(args)


SCRIPTS = ("torch_bench", "torch_convergence_gate", "torch_gather_bench", "torch_profile_step",
           "torch_dist_ab", "torch_to_orbax")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port (the HDF5, ArrayRecord, native
    gather and logging modules, the tools and ``parallel/`` among them),
    the Orbax reader and writer, chip_smoke.py and the port's bench, gate, profiling and Orbax
    scripts loads no jax, flax, optax, grain, orbax, tensorstore, mmearth_tpu
    or __graft_entry__ module, nor the optional h5py,
    array_record, tensorboardX, matplotlib or wandb (the card lacks the
    first three; the port imports each where a path needs it); the sources
    name none of the first."""
    new = ("mmearth_tpu_torch.data.mmearth", "mmearth_tpu_torch.data.pack",
           "mmearth_tpu_torch.data.grain_pipeline", "mmearth_tpu_torch.data.native",
           "mmearth_tpu_torch.utils.logging", "mmearth_tpu_torch.hub",
           "mmearth_tpu_torch.hubconf", "mmearth_tpu_torch.eval.visualize",
           "mmearth_tpu_torch.data.subsample", "mmearth_tpu_torch.utils.flops",
           "mmearth_tpu_torch.utils.profiling", "mmearth_tpu_torch.utils.diagnostics",
           "mmearth_tpu_torch.parallel", "mmearth_tpu_torch.parallel.mesh",
           "mmearth_tpu_torch.checkpoints.orbax_io", "mmearth_tpu_torch.checkpoints.ocdbt",
           "mmearth_tpu_torch.checkpoints.zarr", "mmearth_tpu_torch.checkpoints.zstd",
           "mmearth_tpu_torch.checkpoints.to_flax")
    code = (
        "import importlib, pkgutil, sys, mmearth_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(mmearth_tpu_torch.__path__, 'mmearth_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "sys.path.insert(0, 'scripts')\n"
        f"for m in {SCRIPTS!r}:\n"
        "    importlib.import_module(m)\n"
        f"assert all(m in sys.modules for m in {new!r})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'grain', 'orbax', 'tensorstore', 'mmearth_tpu', '__graft_entry__', 'h5py',"
        " 'array_record', 'tensorboardX', 'matplotlib', 'wandb')]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    for src in [ROOT / "chip_smoke.py", *(ROOT / "scripts" / f"{m}.py" for m in SCRIPTS),
                *(ROOT / "mmearth_tpu_torch").rglob("*.py")]:
        for line in src.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "flax", "optax", "grain", "orbax",
                                                      "tensorstore", "mmearth_tpu",
                                                      "__graft_entry__"), \
                    f"{src}: {line}"


def test_chip_smoke_refuses_without_a_gpu_and_outside_the_repo(tmp_path):
    """No CUDA here: exit non-zero with no result line; alone in a directory
    it cannot import the port either."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, shutil.copy(ROOT / "chip_smoke.py", tmp_path))):
        r = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_main_pretrain_defaults_run_two_steps_on_cpu(tmp_path):
    """The CLI's own model and geometry (convnextv2_pico, 112 px, patch 16:
    the gathered dwconv's p = 16 stage) from 128-px tiles, two steps at batch
    4 in bf16 on the CPU: finite losses, no kernel launched."""
    data = generate_packed(tmp_path / "mmpack", n=11, tile=128, seed=0)
    args = main_pretrain.get_args_parser().parse_args([
        "--batch_size", "4", "--device", "cpu", "--processed_dir", str(data), "--epochs", "1",
        "--warmup_epochs", "1"])
    assert (args.model, args.input_size, args.patch_size) == ("convnextv2_pico", 112, 16)
    before = {**patch_select.LAUNCHES, **wholeblock.LAUNCHES}
    model, history, _ = main_pretrain.main(args)
    assert [e["steps"] for e in history] == [2]
    assert all(math.isfinite(v) for v in history[0]["step_losses"])
    assert {**patch_select.LAUNCHES, **wholeblock.LAUNCHES} == before
    assert model.encoder.dims == (64, 128, 256, 512) and model.encoder.patch_size == 16

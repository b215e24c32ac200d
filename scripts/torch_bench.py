#!/usr/bin/env python3
"""Training throughput of the PyTorch/CUDA port on one GPU (the port's
counterpart of ``bench.py``).

    python3 scripts/torch_bench.py                      # atto56, the headline
    python3 scripts/torch_bench.py --config tiny112
    python3 scripts/torch_bench.py --config finetune
    python3 scripts/torch_bench.py --input mmpack
    python3 scripts/torch_bench.py --device cpu --batch_size 4 --rounds 1 --steps 2

Configurations (``bench.py:60-63,479-510``, at their published widths):

- ``atto56`` (default): the ``convnextv2_atto`` FCMAE (2/2/6/2, 40-320, one
  decoder Block at 512, 12 output modalities, uncertainty loss), 64-px tiles
  cropped to 56, patch 8, mask ratio 0.6, batch 256, bf16 over f32 params,
  AdamW on ``warmup_cosine(1.5e-4 * B / 256, 0, 200, 40, 1000)``
  (``bench.py:218``).  The headline runs ``--block_impl wholeblock``, the
  path of the Hopper kernels; ``auto_value`` is the same step under
  ``block_impl="auto"``, ``bench.py``'s default routing (the composed tail).
- ``tiny112``: ``convnextv2_tiny`` at 112/16, batch 64, ``wholeblock`` (C's
  separate dW2 pass runs at C = 384 and 768).
- ``finetune``: the dense atto classifier at 112/16, 13 bands, 10 classes,
  batch 64, drop path 0.1, layer decay 0.9, weight decay 0.3, label
  smoothing 0.2 (the m-eurosat recipe, ``bench.py:495-503``).
- ``--input mmpack``: the atto56 step fed from disk: 4,096 synthetic samples
  written by ``data/synthetic.py::generate_packed`` under ``build/`` ->
  ``PackedLoader(order="quasi_random")``, pinning in its worker thread ->
  ``train/step.py::device_batches`` (the copy one batch ahead on a side
  stream) -> the pretraining loop's ``train/pretrain.py::Dispatcher`` at 8
  steps a dispatch (``bench.py:339-420``; the epoch's tail of fewer than 8
  batches runs as single steps, as the pretraining loop runs it, where
  ``bench.py`` skips it), and the same at 1 step a dispatch (``eager_*``),
  with the host-only loader rate (numpy, and pinned on a card) and the
  pinned host-to-device copy rate beside it.
- ``--config seg`` and ``--input grain|hdf5`` raise ``NotImplementedError``:
  the U-Net, the Grain pipeline and the HDF5 reader are not ported yet.

The pretraining and finetune configurations train on one synthetic batch
(``data/synthetic.py::bench_batch``, the arrays ``bench.py`` trains on), put
on the device once.  After a warm-up round, the time is the best of
``--rounds`` (4) rounds of ``--steps`` (30) steps, each round closed by one
``torch.cuda.synchronize()`` (``bench.py:241,267-270``); every step draws a
new crop and mask (``fold_in(gen, step)``, as ``bench.py:247``).  A
pretraining round is one dispatch of ``train/step.py::ChainedStep`` over the
round's steps: on a card one replay of a CUDA graph of 30 steps, as
``bench.py:237-253`` chains K = 30 steps in one jit (its warm-up round
holds the warm-up and the capture, ``capture_s``).  The same rounds of eager
steps are timed beside it (``eager_*``).  The finetune rounds are eager
steps, as JAX's finetune has no chained dispatch.
``--rounds``, ``--steps`` and ``--batch_size`` exist so that tests can run
the script short; the published numbers use their defaults.

The last line of the output is one compact JSON object under ``bench.py``'s
metric name: ``value`` (samples/s), ``ms_per_step`` (the best round's;
every round's in ``round_ms_per_step``), ``unit``, ``peak_mem_gib``
(``torch.cuda.max_memory_allocated``), ``block_impl``, the eager rounds'
``eager_value``, ``eager_ms_per_step``, ``eager_round_ms_per_step`` and
``eager_peak_mem_gib`` on the pretraining configurations, and ``card``
(``nvidia-smi --query-gpu=name,power.limit``).  On an error it is
``{"value": 0.0, "error": ...}`` and the exit code is 1.  MFU is not
reported: it waits for the port of ``utils/flops.py``.  ``--record`` (on a
GPU only) writes the line into ``H100_BENCH.json`` under its configuration.
Nothing here imports JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mmearth_tpu_torch.train.pretrain import resolve_device  # noqa: E402

RECORD = ROOT / "H100_BENCH.json"
# (model, img px, patch px, batch) of each pretraining configuration (bench.py:60-63)
PRETRAIN_CONFIGS = {
    "atto56": ("convnextv2_atto", 56, 8, 256),
    "tiny112": ("convnextv2_tiny", 112, 16, 64),
}
MMPACK_STEPS_PER_DISPATCH = 8  # bench.py:339
FINETUNE = {"model": "convnextv2_atto", "img": 112, "patch": 16, "bands": 13, "classes": 10,
            "batch": 64}
METRICS = {
    "atto56": "mpmae_atto_mmearth64_pretrain_samples_per_sec_per_chip",
    "tiny112": "mpmae_tiny_mmearth128_pretrain_samples_per_sec_per_chip",
    "finetune": "geobench_cls_finetune_atto112_img_per_sec_per_chip",
    "seg": "geobench_seg_finetune_unet_atto112_img_per_sec_per_chip",
}
NOT_PORTED = {
    "seg": "the U-Net (mmearth_tpu/models/unet.py; ROADMAP.md queue 1, item 7)",
    "grain": "the Grain pipeline (mmearth_tpu/data/grain_pipeline.py; ROADMAP.md queue 1, "
             "item 5)",
    "hdf5": "the HDF5 reader (mmearth_tpu/data/mmearth.py; ROADMAP.md queue 1, item 5)",
}


def metric_name(config: str, inp: str) -> str:
    if inp != "synthetic":
        return f"{METRICS['atto56']}_{inp}_input"
    return METRICS[config]


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" on
    the CPU."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[dev.index or 0]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev: torch.device) -> float | None:
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30 if dev.type == "cuda" else None


def round_ms_per_step(dispatch, rounds: int, steps: int, dev: torch.device,
                      per_call: int = 1) -> list[float]:
    """A warm-up round, then ``rounds`` rounds of ``steps`` steps, each closed
    by one device sync; ``dispatch(i)`` runs ``per_call`` steps from step
    ``i`` (``i`` counts every step, so each draws anew).  Returns each timed
    round's ms/step (the result is their best)."""
    i, out = 0, []
    for r in range(rounds + 1):
        t0 = time.perf_counter()
        for _ in range(steps // per_call):
            dispatch(i)
            i += per_call
        sync(dev)
        if r > 0:  # round 0 is the warm-up
            out.append(1e3 * (time.perf_counter() - t0) / steps)
    return out


def pretrain_setup(model_name: str, img: int, patch: int, batch: int, block_impl: str,
                   dev: torch.device, schedule=None):
    """The FCMAE of the configuration as ``main_pretrain`` builds it (seed
    0, bf16, GRN over the device batch) and its AdamW, on ``schedule`` or
    ``bench.py``'s; returns (model, optimizer)."""
    from mmearth_tpu_torch.configs.config import (DataConfig, ModelConfig, PretrainConfig,
                                                  RunConfig)
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.pretrain import build_model
    from mmearth_tpu_torch.train.schedule import warmup_cosine

    cfg = PretrainConfig(
        model=ModelConfig(model=model_name, img_size=img, patch_size=patch,
                          block_impl=block_impl),
        data=DataConfig(batch_size=batch), run=RunConfig(seed=0))
    model = build_model(cfg, dev)
    if schedule is None:
        schedule = warmup_cosine(1.5e-4 * batch / 256, 0.0, 200, 40, 1000)
    opt = AdamW(model.named_parameters(), schedule, cfg.optim.weight_decay, cfg.optim.betas)
    return model, opt


def device_batch(n: int, tile: int, dev: torch.device) -> dict[str, torch.Tensor]:
    from mmearth_tpu_torch.data.synthetic import bench_batch
    from mmearth_tpu_torch.train.step import to_device

    return to_device(bench_batch(n, tile), dev)


def bench_pretrain(config: str, dev: torch.device, block_impl: str = "wholeblock",
                   batch: int | None = None, rounds: int = 4, steps: int = 30,
                   chained: bool = True) -> dict:
    """ms/step, samples/s and peak GiB of one pretraining configuration on
    its resident synthetic batch, a round one ``ChainedStep`` dispatch of
    ``steps`` steps (or, with ``chained`` off, ``steps`` eager steps).  A
    chained run also gives ``graph``, ``ChainedStep.report()``."""
    from mmearth_tpu_torch.train.step import ChainedStep, pretrain_step

    name, img, patch, default_batch = PRETRAIN_CONFIGS[config]
    batch = batch or default_batch
    reset_peak(dev)
    model, opt = pretrain_setup(name, img, patch, batch, block_impl, dev)
    data = device_batch(batch, img + 8, dev)  # crop headroom: 64 for 56, 120 for 112
    gen = torch.Generator(device=dev).manual_seed(0)
    graph = None
    if chained:
        ch = ChainedStep(model, opt, {k: v.expand(steps, *v.shape) for k, v in data.items()})
        ms = round_ms_per_step(lambda i: ch(i, gen), rounds, steps, dev, per_call=steps)
        graph = ch.report()
    else:
        ms = round_ms_per_step(lambda i: pretrain_step(model, opt, data, i, gen), rounds, steps,
                               dev)
    return {"ms_per_step": min(ms), "value": batch * 1e3 / min(ms), "round_ms_per_step": ms,
            "peak_mem_gib": peak_gib(dev), "batch": batch, "block_impl": block_impl,
            "graph": graph}


def bench_finetune(dev: torch.device, batch: int | None = None, rounds: int = 4,
                   steps: int = 30) -> dict:
    """The m-eurosat classification step (``bench.py:495-503``) on one
    resident batch of random 13-band images and labels."""
    import numpy as np

    from mmearth_tpu_torch.configs.config import (FinetuneConfig, ModelConfig, OptimConfig,
                                                  RunConfig)
    from mmearth_tpu_torch.losses.finetune import criterion_fn
    from mmearth_tpu_torch.train.finetune import build_trainable, finetune_step
    from mmearth_tpu_torch.train.step import fold_in, to_device

    f = FINETUNE
    batch = batch or f["batch"]
    cfg = FinetuneConfig(
        model=ModelConfig(model=f["model"], img_size=f["img"], patch_size=f["patch"]),
        optim=OptimConfig(blr=2e-4, min_lr=1e-6, weight_decay=0.3, warmup_epochs=5,
                          betas=(0.9, 0.999), layer_decay=0.9),
        run=RunConfig(epochs=100, seed=0, loss_aggr="unweighted"),
        data_set="m-eurosat", drop_path=0.1, smoothing=0.2, batch_size=batch)
    reset_peak(dev)
    # bench.py:514's warmup_cosine(2e-4 * B / 256, 1e-6, 100, 5, 100): 100 updates an epoch
    model, opt = build_trainable(cfg, f["bands"], f["classes"], 100 * batch, dev)
    rng = np.random.default_rng(0)
    data = to_device({
        "input": rng.normal(size=(batch, f["img"], f["img"], f["bands"])).astype(np.float32),
        "label": rng.integers(0, f["classes"], size=(batch,)).astype(np.int32)}, dev)
    criterion = criterion_fn(cfg.data_set, cfg.smoothing)
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = round_ms_per_step(
        lambda i: finetune_step(model, opt, data, criterion, fold_in(gen, i)), rounds, steps, dev)
    return {"ms_per_step": min(ms), "value": batch * 1e3 / min(ms), "round_ms_per_step": ms,
            "peak_mem_gib": peak_gib(dev), "batch": batch}


def pinned_h2d_bytes_per_s(nbytes: int, dev: torch.device, copies: int = 8) -> float | None:
    """The host-to-device rate of ``copies`` back-to-back copies of a pinned
    buffer of ``nbytes`` (one batch), one sync at the end; None on the CPU."""
    if dev.type != "cuda":
        return None
    host = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out.copy_(host, non_blocking=True)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(copies):
        out.copy_(host, non_blocking=True)
    sync(dev)
    return copies * nbytes / (time.perf_counter() - t0)


def write_pack(path: Path, n_samples: int) -> Path:
    """A synthetic 64-px train split of ``n_samples`` (7/8 of them in train),
    written anew under ``path``."""
    import shutil

    from mmearth_tpu_torch.data.synthetic import generate_packed

    shutil.rmtree(path, ignore_errors=True)
    generate_packed(path, n=n_samples, tile=64, seed=0, splits=("train",))
    return path / "train"


def bench_mmpack(dev: torch.device, batch: int | None = None, n_samples: int = 4096,
                 epochs: int = 3, pack_dir: Path = ROOT / "build" / "bench_data") -> dict:
    """The atto56 ``wholeblock`` step fed from disk through ``PackedLoader``
    and the pretraining loop's input path and ``Dispatcher`` (epoch 0 a
    warm-up, the rest timed) at ``MMPACK_STEPS_PER_DISPATCH`` and, beside
    it, at 1 (``eager_*``), the host-only loader rate (numpy; pinned on a
    card), and the pinned host-to-device rate of a batch's bytes."""
    from mmearth_tpu_torch.data.loader import PackedDataset, PackedLoader
    from mmearth_tpu_torch.train.pretrain import Dispatcher
    from mmearth_tpu_torch.train.step import device_batches

    name, img, patch, default_batch = PRETRAIN_CONFIGS["atto56"]
    batch = batch or default_batch
    ds = PackedDataset(write_pack(pack_dir, n_samples))

    def loader_of(pin: bool):
        return PackedLoader(ds, batch_size=batch, shuffle=True, drop_last=True,
                            order="quasi_random", pin_memory=pin)

    def host_sps(loader) -> float:
        t0, n = time.perf_counter(), 0
        for b in loader:
            n += len(b["sentinel2"])
        return n / (time.perf_counter() - t0)

    loader = loader_of(False)
    if len(loader) == 0:
        raise ValueError(f"{ds.count} train samples make no batch of {batch}")
    loader_sps = host_sps(loader)
    b = next(iter(loader))
    sample_bytes = sum(v.nbytes for v in b.values()) // len(b["sentinel2"])
    h2d = pinned_h2d_bytes_per_s(sample_bytes * batch, dev)
    loader = loader_of(dev.type == "cuda")
    pinned_sps = host_sps(loader) if dev.type == "cuda" else None

    def timed(k: int) -> tuple[float, float | None]:
        """ms/step of the epochs after the first at k steps a dispatch, and
        the peak GiB."""
        reset_peak(dev)
        model, opt = pretrain_setup(name, img, patch, batch, "wholeblock", dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        dispatcher = Dispatcher(model, opt, k, gen)
        step, n_timed, t_timed = 0, 0, 0.0
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            t0 = time.perf_counter()
            for losses in dispatcher.run(device_batches(loader, dev), step):
                step += len(losses)
            sync(dev)
            if epoch > 0:  # epoch 0 is the warm-up
                n_timed += len(loader)
                t_timed += time.perf_counter() - t0
        return 1e3 * t_timed / n_timed, peak_gib(dev)

    eager_ms, eager_peak = timed(1)
    ms, peak = timed(MMPACK_STEPS_PER_DISPATCH)
    return {"ms_per_step": ms, "value": batch * 1e3 / ms, "peak_mem_gib": peak,
            "eager_value": batch * 1e3 / eager_ms, "eager_ms_per_step": eager_ms,
            "eager_peak_mem_gib": eager_peak,
            "batch": batch, "block_impl": "wholeblock", "input": "mmpack",
            "steps_per_dispatch": MMPACK_STEPS_PER_DISPATCH, "batches_per_epoch": len(loader),
            "loader_only_host_sps": loader_sps, "loader_pinned_host_sps": pinned_sps,
            "sample_mbytes": sample_bytes / 1e6,
            "h2d_mbytes_per_sec": None if h2d is None else h2d / 1e6,
            "h2d_bound_sps": None if h2d is None else h2d / sample_bytes,
            "pack_samples": ds.count, "epochs_timed": epochs - 1, "host_cores": os.cpu_count()}


def run(args) -> dict:
    """The result line of ``args`` (raises on any failure)."""
    if args.config in NOT_PORTED:
        raise NotImplementedError(f"--config {args.config} needs {NOT_PORTED[args.config]}, "
                                  "which the PyTorch port does not have yet")
    if args.input in NOT_PORTED:
        raise NotImplementedError(f"--input {args.input} needs {NOT_PORTED[args.input]}, "
                                  "which the PyTorch port does not have yet")
    if args.input == "mmpack" and args.config != "atto56":
        raise ValueError("--input mmpack feeds the atto56 step; drop --config")
    dev = resolve_device(args.device)
    if args.record and dev.type != "cuda":
        raise ValueError("--record keeps GPU measurements only")
    timing = {"rounds": args.rounds, "steps": args.steps}
    if args.input == "mmpack":
        out, unit, timing = bench_mmpack(dev, args.batch_size), "samples/s/chip", {}
    elif args.config == "finetune":
        out, unit = bench_finetune(dev, args.batch_size, args.rounds, args.steps), "img/s/chip"
    else:
        eager = bench_pretrain(args.config, dev, "wholeblock", args.batch_size, args.rounds,
                               args.steps, chained=False)
        out = bench_pretrain(args.config, dev, "wholeblock", args.batch_size, args.rounds,
                             args.steps)
        unit = "samples/s/chip"
        out.update({f"eager_{key}": eager[key] for key in
                    ("value", "ms_per_step", "round_ms_per_step", "peak_mem_gib")})
        out.update(capture_s=out.pop("graph")["capture_s"])
        if args.config == "atto56":
            auto = bench_pretrain(args.config, dev, "auto", args.batch_size, args.rounds,
                                  args.steps)
            out.update(auto_value=auto["value"], auto_ms_per_step=auto["ms_per_step"],
                       auto_round_ms_per_step=auto["round_ms_per_step"],
                       auto_peak_mem_gib=auto["peak_mem_gib"])
    return {"metric": metric_name(args.config, args.input), "value": out.pop("value"),
            "unit": unit, **out, **timing, "device": dev.type, "card": card(dev)}


def record(line: dict, key: str) -> None:
    try:
        recs = json.loads(RECORD.read_text())
    except FileNotFoundError:
        recs = {}
    recs[key] = line
    RECORD.write_text(json.dumps(recs, indent=1) + "\n")


def get_args_parser():
    p = argparse.ArgumentParser(description="Training throughput of the PyTorch port")
    p.add_argument("--config", default="atto56", choices=["atto56", "tiny112", "finetune", "seg"])
    p.add_argument("--input", default="synthetic", choices=["synthetic", "mmpack", "grain", "hdf5"])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--rounds", type=int, default=4, help="timed rounds (best is kept)")
    p.add_argument("--steps", type=int, default=30, help="steps a round")
    p.add_argument("--batch_size", type=int, default=None,
                   help="the configuration's batch by default (256, 64, 64)")
    p.add_argument("--record", action="store_true",
                   help="write the line into H100_BENCH.json under its configuration")
    return p


def main(argv=None) -> int:
    args = get_args_parser().parse_args(argv)
    metric = metric_name(args.config, args.input)
    try:
        line = run(args)
    except Exception as e:  # the boundary: report the failure as the result line
        traceback.print_exc()
        print(json.dumps({"metric": metric, "value": 0.0, "error": f"{type(e).__name__}: {e}"},
                         separators=(",", ":")), flush=True)
        return 1
    if args.record:
        record(line, args.input if args.input != "synthetic" else args.config)
    print(json.dumps(line, separators=(",", ":")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

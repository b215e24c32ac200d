#!/usr/bin/env python3
"""Where the time of one training step of the PyTorch port goes, on a GPU.

    python3 scripts/torch_profile_step.py [--batch_size 256] [--steps 5] \
        [--sparse_impl gathered] [--block_impl dwg]
    python3 scripts/torch_profile_step.py --task finetune [--batch_size 32]
    python3 scripts/torch_profile_step.py --task probe

``--task pretrain`` (the default) runs the atto-56/8 bf16 configuration of
``mmearth_tpu_torch.main_pretrain`` with the given encoder (``--sparse_impl
gathered`` or ``masked_dense``) and block tail (``--block_impl``:
``dwg``/``auto``, composed; ``wholeblock``, the spill-g kernels on the
gathered encoder; ``fused``, the masked-dense kernels) on synthetic 64-px
mmpack data.  ``--task finetune`` and ``probe`` run the GEO-Bench recipe of
``mmearth_tpu_torch.main_finetune`` (the dense convnextv2_atto classifier at
patch 8, bf16, drop path 0.1, layer decay 0.9; the probe trains the head
alone) on synthetic m-eurosat, from random weights.  Data is written under
``build/profile_data``.  A few warm-up steps, then ``--steps`` steps under
``torch.profiler``; prints one JSON line: the wall ms/step (host clock around
synchronised steps), the host ms/step spent waiting for the loader and
copying the batch to the card, the device busy ms/step (the sum of kernel
times; one stream, so kernels do not overlap) and idle share, and the device
time by kernel group and by the top kernels.  With ``--no_profiler`` every
batch is copied to the card first and the steps run without the profiler;
the line then holds the wall ms/step (host clock) and the CUDA-event ms/step
of the same loop, with no input time in either.  Needs a CUDA GPU; it
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# kernel-name fragments (a tuple: all of them) -> group, first match wins
GROUPS = (
    ("dw7_wgrad", "dense dwconv dW (port kernel)"),
    (("fwd_stat_kernel", "SpillRows"), "spill-g fwd A (port kernel)"),  # row 7
    ("spillg_fwd_a", "spill-g fwd A (port kernel)"),  # row 7's earlier kernel
    ("spillg_fwd_b", "spill-g fwd B (port kernel)"),  # row 8
    ("spillg_bwd", "spill-g bwd C/D row passes (port kernels)"),
    ("SpillRows", "spill-g bwd C/D row passes (port kernels)"),  # D: bwd_dv_kernel<..., SpillRows>
    ("fwd_stat_kernel", "masked-dense fwd stat/apply (port kernels)"),  # <..., KeptRows>
    ("masked_fwd", "masked-dense fwd stat/apply (port kernels)"),
    ("masked_bwd", "masked-dense bwd stat/dv row passes (port kernels)"),
    ("KeptRows", "masked-dense bwd stat/dv row passes (port kernels)"),
    ("spillg_atb", "dW1/dW2 X^T Y passes (port kernel)"),
    ("dw7_fwd", "dwconv7_gathered fwd (port kernel)"),
    ("dw7_bwd", "dwconv7_gathered bwd (port kernel)"),
    ("patch_copy", "patch gather/scatter (port kernel)"),  # rows 1-2: patch_copy_bulk/_reg
    ("gather_kernel", "patch gather/scatter (port kernel)"),  # their earlier kernels
    ("scatter_kernel", "patch gather/scatter (port kernel)"),
    ("multi_tensor_apply", "optimizer (foreach)"),
    ("gemm", "matmul (cuBLAS)"),
    ("xmma", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("conv", "convolution (cuDNN)"),
    ("cudnn", "convolution (cuDNN)"),
    ("reduce", "reductions"),
    ("Memcpy", "memcpy"),
    ("Memset", "memset"),
    ("elementwise", "elementwise"),
    ("index", "indexing"),
    ("gather", "indexing"),
    ("scatter", "indexing"),
)


def group_of(name: str) -> str:
    low = name.lower()
    for frags, group in GROUPS:
        if all(f.lower() in low for f in ((frags,) if isinstance(frags, str) else frags)):
            return group
    return "other"


def pretrain_stepper(args, data: Path, n_steps: int, dev):
    """A function running pretraining step ``i`` on the next batch."""
    from mmearth_tpu_torch import main_pretrain
    from mmearth_tpu_torch.data.synthetic import generate_packed
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.pretrain import build_model, get_dataloader
    from mmearth_tpu_torch.train.schedule import warmup_cosine
    from mmearth_tpu_torch.train.step import pretrain_step

    # the train split is 7/8 of the samples (data/synthetic.py::splits_of)
    generate_packed(data, n=(args.batch_size * n_steps * 8) // 7 + 8, tile=64, seed=0)
    cfg = main_pretrain.config_from_args(main_pretrain.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--batch_size", str(args.batch_size), "--use_bf16", "True", "--processed_dir", str(data),
        "--epochs", "1", "--warmup_epochs", "1", "--sparse_impl", args.sparse_impl,
        "--block_impl", args.block_impl]))
    model = build_model(cfg, dev)
    _, loader = get_dataloader(cfg)
    opt = AdamW(model.named_parameters(), warmup_cosine(1.5e-4, 0.0, 1, 1, n_steps),
                cfg.optim.weight_decay, cfg.optim.betas)
    gen = torch.Generator(device=dev).manual_seed(0)
    return loader, lambda batch, i: pretrain_step(model, opt, batch, i, gen)


def finetune_stepper(args, data: Path, n_steps: int, dev):
    """A function running finetune (or probe) step ``i`` on the next batch:
    the recipe's flags, set up by ``train/finetune.py::build_trainable`` as
    ``main_finetune`` sets it up."""
    from mmearth_tpu_torch import main_finetune
    from mmearth_tpu_torch.data.geobench import generate_synthetic_geobench
    from mmearth_tpu_torch.data.geobench import get_geobench_dataloaders
    from mmearth_tpu_torch.losses.finetune import criterion_fn
    from mmearth_tpu_torch.train.finetune import build_trainable, finetune_step
    from mmearth_tpu_torch.train.step import fold_in

    probe = args.task == "probe"
    generate_synthetic_geobench(data, "m-eurosat", (args.batch_size * n_steps, 8, 8))
    cfg = main_finetune.config_from_args(main_finetune.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--data_set", "m-eurosat", "--processed_dir", str(data),
        "--batch_size", str(args.batch_size), "--epochs", "1", "--blr", "1e-2" if probe else "2e-4",
        "--layer_decay", "0.9", "--weight_decay", "0.3", "--drop_path", "0.1",
        "--smoothing", "0.2", "--use_bf16", "True", "--seed", "0", "--linear_probe", str(probe)]))
    (loader, _, _), task = get_geobench_dataloaders(cfg.data_set, data, args.batch_size,
                                                    splits=("train", "val", "test"))
    model, opt = build_trainable(cfg, 12, task.num_classes, len(loader.dataset), dev)
    criterion = criterion_fn(cfg.data_set, cfg.smoothing)
    gen = torch.Generator(device=dev).manual_seed(cfg.run.seed)
    return loader, lambda batch, i: finetune_step(model, opt, batch, criterion, fold_in(gen, i))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="pretrain", choices=["pretrain", "finetune", "probe"])
    ap.add_argument("--batch_size", type=int, default=None,
                    help="256 for pretrain, 32 for finetune and probe")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--no_profiler", action="store_true",
                    help="time the steps alone, their batches already on the card")
    ap.add_argument("--sparse_impl", default="gathered", choices=["gathered", "masked_dense"])
    ap.add_argument("--block_impl", default="dwg", choices=["auto", "xla", "dwg", "spillg",
                                                            "wholeblock", "fused"])
    args = ap.parse_args()
    if args.batch_size is None:
        args.batch_size = 256 if args.task == "pretrain" else 32
    if not torch.cuda.is_available():
        print("torch_profile_step: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from mmearth_tpu_torch.train.step import to_device

    n_steps = args.warmup + args.steps
    data = ROOT / "build" / "profile_data"
    shutil.rmtree(data, ignore_errors=True)
    dev = torch.device("cuda")
    make = pretrain_stepper if args.task == "pretrain" else finetune_stepper
    loader, run = make(args, data, n_steps, dev)
    it = iter(loader)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    head = {"card": smi, "task": args.task,
            **({"sparse_impl": args.sparse_impl, "block_impl": args.block_impl}
               if args.task == "pretrain" else {}),
            "batch_size": args.batch_size, "steps": args.steps}

    if args.no_profiler:
        # every batch on the card before the clock starts: no input time
        batches = [to_device(next(it), dev) for _ in range(n_steps)]
        for i in range(args.warmup):
            run(batches[i], i)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for i in range(args.warmup, n_steps):
            run(batches[i], i)
        end.record()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        print(json.dumps({**head, "profiler": False,
                          "wall_ms_per_step": 1e3 * wall_s / args.steps,
                          "event_ms_per_step": start.elapsed_time(end) / args.steps}))
        return 0

    def step(i: int) -> float:
        t0 = time.perf_counter()
        batch = to_device(next(it), dev)
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        run(batch, i)
        return host

    for i in range(args.warmup):
        step(i)
    torch.cuda.synchronize()
    host_s = 0.0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.warmup, n_steps):
            host_s += step(i)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    by_kernel: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            by_kernel[ev.key] += ev.self_device_time_total / 1e3  # us -> ms
            counts[ev.key] += ev.count
    busy = sum(by_kernel.values())
    groups: dict[str, float] = defaultdict(float)
    for name, ms in by_kernel.items():
        groups[group_of(name)] += ms
    per = 1.0 / args.steps
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        **head, "profiler": True,
        "wall_ms_per_step": 1e3 * wall_s * per,
        "host_input_ms_per_step": 1e3 * host_s * per,
        "device_busy_ms_per_step": busy * per,
        "device_idle_share": 1.0 - busy / (1e3 * wall_s),
        "kernels_per_step": sum(counts.values()) * per,
        "groups_ms_per_step": {g: ms * per for g, ms in sorted(groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:90], "ms_per_step": ms * per, "launches_per_step": counts[n] * per}
                        for n, ms in top],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the time of one pretraining step of the PyTorch port goes, on a GPU.

    python3 scripts/torch_profile_step.py [--batch_size 256] [--steps 5] [--block_impl dwg]

Runs the atto-56/8 bf16 configuration of ``mmearth_tpu_torch.main_pretrain``
with the given ``--block_impl`` (``dwg``: composed block tail; ``wholeblock``:
the spill-g tail kernels)
(synthetic 64-px mmpack data, written under ``build/profile_data``) for a few
warm-up steps, then profiles ``--steps`` steps with ``torch.profiler`` and
prints one JSON line: the wall ms/step (host clock around synchronised
steps), the host ms/step spent waiting for the loader and copying the batch
to the card, the device busy ms/step (the sum of kernel times; one stream, so
kernels do not overlap) and idle share, and the device time by kernel group
and by the top kernels.  Needs a CUDA GPU; it imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# kernel-name fragments -> group, first match wins
GROUPS = (
    ("spillg_fwd", "spill-g fwd A/B (port kernels)"),
    ("spillg_bwd", "spill-g bwd C/D row passes (port kernels)"),
    ("spillg_atb", "spill-g dW1/dW2 (port kernel)"),
    ("dw7_fwd", "dwconv7_gathered fwd (port kernel)"),
    ("dw7_bwd", "dwconv7_gathered bwd (port kernel)"),
    ("gather_kernel", "patch gather/scatter (port kernel)"),
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
    for frag, group in GROUPS:
        if frag.lower() in name.lower():
            return group
    return "other"


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--block_impl", default="dwg", choices=["auto", "xla", "dwg", "spillg",
                                                            "wholeblock"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_step: needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from torch.profiler import ProfilerActivity, profile

    from mmearth_tpu_torch import main_pretrain
    from mmearth_tpu_torch.data.synthetic import generate_packed
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.pretrain import build_model, get_dataloader
    from mmearth_tpu_torch.train.schedule import warmup_cosine
    from mmearth_tpu_torch.train.step import pretrain_step, to_device

    n_steps = args.warmup + args.steps
    data = ROOT / "build" / "profile_data"
    # the train split is 7/8 of the samples (data/synthetic.py::splits_of)
    generate_packed(data, n=(args.batch_size * n_steps * 8) // 7 + 8, tile=64, seed=0)
    cfg = main_pretrain.config_from_args(main_pretrain.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--batch_size", str(args.batch_size), "--use_bf16", "True", "--processed_dir", str(data),
        "--epochs", "1", "--warmup_epochs", "1", "--block_impl", args.block_impl]))
    dev = torch.device("cuda")
    model = build_model(cfg, dev)
    _, loader = get_dataloader(cfg)
    opt = AdamW(model.named_parameters(), warmup_cosine(1.5e-4, 0.0, 1, 1, n_steps),
                cfg.optim.weight_decay, cfg.optim.betas)
    gen = torch.Generator(device=dev).manual_seed(0)
    it = iter(loader)

    def step(i: int) -> float:
        t0 = time.perf_counter()
        batch = to_device(next(it), dev)
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        pretrain_step(model, opt, batch, i, gen)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "card": smi, "block_impl": args.block_impl, "batch_size": args.batch_size,
        "steps": args.steps,
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

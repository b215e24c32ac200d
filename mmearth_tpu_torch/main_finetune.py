#!/usr/bin/env python
"""GEO-Bench finetuning / linear-probe CLI of the PyTorch/CUDA port, with the
flag names of the JAX CLI (``main_finetune.py``, itself the reference's,
main_finetune.py:59-424).

    python -m mmearth_tpu_torch.main_finetune --device cuda --model convnextv2_atto \\
        --input_size 56 --patch_size 8 --data_set m-eurosat --finetune <pretrain .pth> \\
        --batch_size 32 --epochs 100 --blr 2e-4 --layer_decay 0.9 --weight_decay 0.3 \\
        --drop_path 0.1 --smoothing 0.2 --processed_dir <packed GEO-Bench dir>

``--linear_probe True --blr 1e-2`` trains the head alone.  Segmentation
(``--data_set m-cashew-plant`` or ``m-SA-crop-type``) trains a
``convnextv2_unet_*`` U-Net as the probe with the staged unfreeze, from
``FinetuneConfig.unfreeze_epoch`` (50) on the whole model:

    python -m mmearth_tpu_torch.main_finetune --device cuda --model convnextv2_unet_atto \
        --input_size 112 --patch_size 16 --data_set m-cashew-plant --linear_probe True \
        --finetune <pretrain .pth> --batch_size 16 --epochs 100 --layer_decay 0.9 \
        --weight_decay 0.3 --processed_dir <packed GEO-Bench dir>

The baselines are ``--model resnet18|resnet50`` (classification) and
``resnet18_unet|resnet50_unet`` (segmentation) from a foreign ``.pth`` whose
path names its source (``seco``, ``gassl``, ``satlas``; else torchvision
keys).  ``--device`` (default ``cuda``) is honoured; asking for CUDA without
a card raises.  ``--wandb True`` logs each epoch to Weights & Biases where
the package is installed (training goes on without it).

Data parallel over W GPUs, one process each (``parallel/mesh.py``):
``torchrun --standalone --nproc_per_node W -m mmearth_tpu_torch.main_finetune
--distributed True ...``, ``--batch_size`` each rank's, as in
``main_pretrain``.
"""
from __future__ import annotations

import argparse

from .configs.config import FinetuneConfig, ModelConfig, OptimConfig, RunConfig

GEO_BENCH_DATASETS = [
    "m-eurosat", "m-so2sat", "m-bigearthnet", "m-brick-kiln",
    "m-cashew-plant", "m-SA-crop-type",
]


def str2bool(v):
    return str(v).lower() in ("yes", "true", "t", "1")


def get_args_parser():
    p = argparse.ArgumentParser("GEO-Bench fine-tuning (PyTorch/CUDA)", add_help=False)
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--epochs", default=100, type=int)
    p.add_argument("--update_freq", default=1, type=int)

    p.add_argument("--model", default="convnextv2_atto", type=str,
                   help="convnextv2_<size>, convnextv2_unet_<size>, resnet18, resnet50, "
                        "resnet18_unet or resnet50_unet")
    p.add_argument("--input_size", default=56, type=int)
    p.add_argument("--patch_size", default=8, type=int)
    p.add_argument("--use_orig_stem", type=str2bool, default=False)
    p.add_argument("--padding_mode", choices=["same", "reference"], default="same")
    p.add_argument("--drop_path", type=float, default=0.1)
    p.add_argument("--head_init_scale", default=0.001, type=float)

    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--blr", type=float, default=5e-4)
    p.add_argument("--min_lr", type=float, default=1e-6)
    p.add_argument("--warmup_epochs", type=int, default=0)
    p.add_argument("--layer_decay", type=float, default=1.0)
    p.add_argument("--layer_decay_type", choices=["single", "group"], default="single")
    p.add_argument("--opt_betas", nargs=2, type=float, default=[0.9, 0.999])
    p.add_argument("--opt", default="adamw", type=str,
                   help="optimizer family: adamw, adam, nadam, radam, sgd, nesterov, momentum, "
                        "adadelta, adafactor, rmsprop, rmsproptf, novograd, nvnovograd, lamb "
                        "(a fused prefix maps to the plain family)")
    p.add_argument("--opt_eps", default=1e-8, type=float)
    p.add_argument("--momentum", default=0.9, type=float)
    p.add_argument("--clip_grad", type=float, default=None)
    p.add_argument("--smoothing", type=float, default=0.2)

    p.add_argument("--finetune", default="",
                   help="pretrain checkpoint (.pth); a foreign ResNet .pth for the baselines")
    p.add_argument("--use_imnet_weights", type=str2bool, default=False)
    p.add_argument("--linear_probe", type=str2bool, default=False)
    p.add_argument("--data_set", default="m-eurosat", choices=GEO_BENCH_DATASETS)
    p.add_argument("--partition", default="default", type=str)
    p.add_argument("--geobench_bands_type", default="full", choices=["full", "rgb", "bgr"])
    p.add_argument("--processed_dir", default=None, type=str)
    p.add_argument("--nb_classes", default=None, type=int)
    p.add_argument("--output_dir", default="")
    p.add_argument("--log_dir", default=None, help="TensorBoard events (needs tensorboardX)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--auto_resume", type=str2bool, default=True)
    p.add_argument("--save_ckpt", type=str2bool, default=True)
    p.add_argument("--save_ckpt_freq", default=1, type=int)
    p.add_argument("--save_ckpt_num", default=3, type=int)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--num_workers", default=10, type=int,
                   help="the most threads of the native row gather (0: half the cores)")
    p.add_argument("--use_bf16", type=str2bool, default=True,
                   help="bf16 compute over f32 params (replaces --use_mixed/AMP)")
    p.add_argument("--debug", type=str2bool, default=False)
    p.add_argument("--run_on_test", type=str2bool, default=True)

    p.add_argument("--wandb", type=str2bool, default=False)
    p.add_argument("--wandb_project", type=str, default="mmearth-v001-ft")
    p.add_argument("--wandb_run_name", type=str, default=None)

    p.add_argument("--model_ema", type=str2bool, default=False)
    p.add_argument("--model_ema_decay", type=float, default=0.9999)
    p.add_argument("--model_ema_eval", type=str2bool, default=False)

    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # reference-compatible no-ops (mixup/DDP/torch plumbing), as the JAX CLI
    for flag in ["--model_ema_force_cpu", "--dist_on_itp", "--no_ffcv", "--use_mixed",
                 "--baseline", "--pretraining", "--use_amp", "--eval", "--pin_mem",
                 "--resplit"]:
        p.add_argument(flag, type=str2bool, default=False)
    p.add_argument("--distributed", type=str2bool, default=False)
    p.add_argument("--model_prefix", default="")
    p.add_argument("--model_key", default="model|module")
    p.add_argument("--crop_pct", type=float, default=None)
    p.add_argument("--version", default="1.0")
    p.add_argument("--dist_url", default="env://")
    p.add_argument("--eval_data_path", default=None)
    p.add_argument("--local_rank", "--local-rank", default=-1, type=int)
    p.add_argument("--world_size", default=1, type=int)
    p.add_argument("--warmup_steps", default=-1, type=int)
    p.add_argument("--weight_decay_end", default=None, type=float)
    p.add_argument("--aa", default="rand-m9-mstd0.5-inc1")
    p.add_argument("--color_jitter", default=0.4, type=float)
    p.add_argument("--train_interpolation", default="bicubic")
    p.add_argument("--reprob", default=0.25, type=float)
    p.add_argument("--remode", default="pixel")
    p.add_argument("--recount", default=1, type=int)
    p.add_argument("--mixup", default=0.0, type=float)
    p.add_argument("--cutmix", default=0.0, type=float)
    p.add_argument("--cutmix_minmax", nargs="+", type=float, default=None)
    p.add_argument("--mixup_prob", default=1.0, type=float)
    p.add_argument("--mixup_switch_prob", default=0.5, type=float)
    p.add_argument("--mixup_mode", default="batch")
    p.add_argument("--test_scores_dir", default=None)
    return p


def config_from_args(args) -> FinetuneConfig:
    return FinetuneConfig(
        model=ModelConfig(
            model=args.model, img_size=args.input_size, patch_size=args.patch_size,
            use_orig_stem=args.use_orig_stem, padding_mode=args.padding_mode,
        ),
        optim=OptimConfig(
            blr=args.blr, lr=args.lr, min_lr=args.min_lr, weight_decay=args.weight_decay,
            warmup_epochs=args.warmup_epochs, betas=tuple(args.opt_betas),
            update_freq=args.update_freq, layer_decay=args.layer_decay,
            layer_decay_type=args.layer_decay_type, clip_grad=args.clip_grad,
            opt=args.opt, opt_eps=args.opt_eps, momentum=args.momentum,
        ),
        run=RunConfig(
            epochs=args.epochs, start_epoch=args.start_epoch, seed=args.seed,
            output_dir=args.output_dir, log_dir=args.log_dir, resume=args.resume,
            auto_resume=args.auto_resume,
            save_ckpt=args.save_ckpt, save_ckpt_freq=args.save_ckpt_freq,
            save_ckpt_num=args.save_ckpt_num, loss_aggr="unweighted",
            use_bf16=args.use_bf16, wandb=args.wandb, wandb_project=args.wandb_project,
            wandb_run_name=args.wandb_run_name,
        ),
        data_set=args.data_set, partition=args.partition,
        geobench_bands_type=args.geobench_bands_type, processed_dir=args.processed_dir,
        nb_classes=args.nb_classes or 0, finetune=args.finetune,
        use_imnet_weights=args.use_imnet_weights,
        linear_probe=args.linear_probe, smoothing=args.smoothing,
        drop_path=args.drop_path, head_init_scale=args.head_init_scale,
        batch_size=args.batch_size, num_workers=args.num_workers,
        model_ema=args.model_ema, model_ema_decay=args.model_ema_decay,
        model_ema_eval=args.model_ema_eval,
    )


def main(args, loaders=None, task=None):
    """Run the finetune (or probe) of ``args``; returns
    :func:`~mmearth_tpu_torch.train.finetune.run_finetune`'s dict (the
    per-epoch history and the final scores)."""
    from .train.finetune import run_finetune

    return run_finetune(config_from_args(args), loaders=loaders, task=task, device=args.device,
                        args=vars(args))


if __name__ == "__main__":
    parser = argparse.ArgumentParser("GEO-Bench fine-tuning (PyTorch/CUDA)",
                                     parents=[get_args_parser()])
    main(parser.parse_args())

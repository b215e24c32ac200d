#!/usr/bin/env python
"""FCMAE pretraining CLI of the PyTorch/CUDA port, with the flag names of the
JAX CLI (``main_pretrain.py``, itself the reference's, main_pretrain.py:30-162).

    python -m mmearth_tpu_torch.main_pretrain --device cuda --model convnextv2_atto \\
        --input_size 56 --patch_size 8 --batch_size 256 --processed_dir <mmpack dir>

``--device`` (default ``cuda``) is honoured; asking for CUDA without a card
raises.  Flags whose non-default values select code this port does not have
yet are accepted and refused with an error naming what is missing.
"""
from __future__ import annotations

import argparse

from .configs import modalities as M
from .configs.config import DataConfig, ModelConfig, OptimConfig, PretrainConfig, RunConfig


def str2bool(v):
    return str(v).lower() in ("yes", "true", "t", "1")


def get_args_parser():
    p = argparse.ArgumentParser("FCMAE pre-training (PyTorch/CUDA)", add_help=False)
    p.add_argument("--wandb", type=str2bool, default=False)
    p.add_argument("--wandb_project", type=str, default="global-lr")
    p.add_argument("--wandb_run_name", type=str, default=None)

    p.add_argument("--batch_size", default=64, type=int, help="per-device batch size")
    p.add_argument("--epochs", default=800, type=int)
    p.add_argument("--warmup_epochs", type=int, default=40)
    p.add_argument("--update_freq", default=1, type=int, help="gradient accumulation steps")

    p.add_argument("--loss_aggr", choices=["uncertainty", "unweighted"], default="uncertainty")
    p.add_argument("--loss_full", type=str2bool, default=False)

    p.add_argument("--model", default="convnextv2_pico", type=str)
    p.add_argument("--input_size", default=112, type=int)
    p.add_argument("--mask_ratio", default=0.6, type=float)
    p.add_argument("--norm_pix_loss", type=str2bool, default=False)
    p.add_argument("--decoder_depth", type=int, default=1)
    p.add_argument("--decoder_embed_dim", type=int, default=512)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--use_orig_stem", type=str2bool, default=False)

    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--blr", type=float, default=1.5e-4)
    p.add_argument("--min_lr", type=float, default=0.0)

    p.add_argument("--data_dir", default=str(M.mmearth_dir()), type=str)
    p.add_argument("--processed_dir", default=None, type=str)
    p.add_argument("--random_crop", type=str2bool, default=True)
    p.add_argument("--output_dir", default="")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--resume", default="")
    p.add_argument("--auto_resume", type=str2bool, default=True)
    p.add_argument("--save_ckpt", type=str2bool, default=True)
    p.add_argument("--save_ckpt_freq", default=1, type=int)
    p.add_argument("--save_ckpt_num", default=3, type=int)
    p.add_argument("--start_epoch", default=0, type=int)
    p.add_argument("--num_workers", default=10, type=int,
                   help="accepted; the port's numpy row gather runs in one thread")
    p.add_argument("--debug", type=str2bool, default=False)
    p.add_argument("--use_bf16", type=str2bool, default=True,
                   help="bf16 compute over f32 params (replaces --use_mixed/AMP)")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="pretraining steps a dispatch: k > 1 replays a CUDA graph of k steps "
                        "(the CPU runs them one after another), as the JAX CLI's lax.scan")
    p.add_argument("--block_impl", default="auto",
                   choices=["auto", "xla", "fused", "spillg", "remat", "folded", "dwg",
                            "wholeblock"],
                   help="the block tail: on the gathered encoder (every block's dwconv "
                        "through the dwconv7_gathered kernel) spillg and wholeblock (the "
                        "same code in this port) run it through the spill-g kernels (every "
                        "stage width, convnextv2_huge's included); on the "
                        "masked-dense encoder fused runs it through the masked-dense "
                        "kernels; every other choice, and every choice on the other "
                        "encoder, composes it from torch ops; remat and folded are not "
                        "ported yet")
    p.add_argument("--sparse_impl", choices=["gathered", "masked_dense"], default="gathered",
                   help="gathered: the encoder on the visible patches only; masked_dense: "
                        "on the full grid with re-masking (the same function)")
    p.add_argument("--grn_scope", choices=["global", "per_device"], default="per_device")
    p.add_argument("--gelu_approx", type=str2bool, default=False)
    p.add_argument("--loader", choices=["mmpack", "grain", "hdf5"], default="mmpack")
    p.add_argument("--order", choices=["random", "quasi_random", "sequential"], default=None)

    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for flag, default in [("--dist_url", "env://"), ("--crop_pct", None), ("--world_size", 1)]:
        p.add_argument(flag, default=default)
    p.add_argument("--local_rank", "--local-rank", default=-1, type=int)
    p.add_argument("--dist_on_itp", type=str2bool, default=False)
    p.add_argument("--use_mixed", type=str2bool, default=False)
    p.add_argument("--sparse", type=str2bool, default=True)
    p.add_argument("--distributed", type=str2bool, default=False)
    p.add_argument("--no_ffcv", type=str2bool, default=True)
    return p


# flag -> (value the port runs, what a different value would need)
_NOT_PORTED = {
    "gelu_approx": (False, "the tanh GELU"),
    "use_orig_stem": (False, "the original 4x4 stem"),
    "sparse": (True, "the dense (leaky) encoder path"),
    "loader": ("mmpack", "the grain and HDF5 loaders"),
    "log_dir": (None, "TensorBoard logging"),
    "wandb": (False, "wandb logging"),
    "distributed": (False, "multi-GPU training"),
}


def config_from_args(args) -> PretrainConfig:
    for flag, (value, needs) in _NOT_PORTED.items():
        if getattr(args, flag) != value:
            raise NotImplementedError(f"--{flag} {getattr(args, flag)}: needs {needs}, "
                                      "which the PyTorch port does not have yet")
    return PretrainConfig(
        model=ModelConfig(
            model=args.model, img_size=args.input_size, patch_size=args.patch_size,
            mask_ratio=args.mask_ratio, decoder_depth=args.decoder_depth,
            decoder_embed_dim=args.decoder_embed_dim, norm_pix_loss=args.norm_pix_loss,
            grn_scope=args.grn_scope, block_impl=args.block_impl,
            sparse_impl=args.sparse_impl,
        ),
        optim=OptimConfig(
            blr=args.blr, lr=args.lr, min_lr=args.min_lr, weight_decay=args.weight_decay,
            warmup_epochs=args.warmup_epochs, update_freq=args.update_freq,
        ),
        data=DataConfig(
            data_dir=args.data_dir, processed_dir=args.processed_dir,
            batch_size=args.batch_size,
            random_crop=args.random_crop, debug=args.debug, order=args.order,
        ),
        run=RunConfig(
            epochs=args.epochs, start_epoch=args.start_epoch, seed=args.seed,
            output_dir=args.output_dir, resume=args.resume, auto_resume=args.auto_resume,
            save_ckpt=args.save_ckpt, save_ckpt_freq=args.save_ckpt_freq,
            save_ckpt_num=args.save_ckpt_num, loss_aggr=args.loss_aggr,
            loss_full=args.loss_full, use_bf16=args.use_bf16,
            steps_per_dispatch=args.steps_per_dispatch,
        ),
    )


def main(args):
    from .train.pretrain import run_pretrain

    return run_pretrain(config_from_args(args), device=args.device, args=vars(args))


if __name__ == "__main__":
    parser = argparse.ArgumentParser("FCMAE pre-training (PyTorch/CUDA)",
                                     parents=[get_args_parser()])
    main(parser.parse_args())

#!/usr/bin/env python3
"""A port run's ``.pth`` checkpoints as the JAX package's Orbax checkpoints,
which its ``--resume``, auto-resume and ``--finetune`` take
(``mmearth_tpu_torch/checkpoints/orbax_io.py``; no orbax or JAX needed).

    python3 scripts/torch_to_orbax.py PTH_OR_RUN_DIR [--output_dir DIR]
        [--data_path DIR] [--num_workers N]

* ``checkpoint-<e>.pth`` becomes the step ``<output_dir>/checkpoints/<e>/``
  (params, the optax state of the run's ``--opt`` chain, ``step``, the
  ResNets' ``batch_stats``, the EMA) and, for a ``--loader grain``
  pretraining run, each rank's grain position ``loader-<e>[-p<r>].bin``;
* ``checkpoint-best.pth`` becomes the params directory
  ``<output_dir>/checkpoint-best``;
* a run directory: its newest ``checkpoint-<e>.pth`` and its
  ``checkpoint-best.pth`` where it has one.

The model and the optimizer are rebuilt from the flags the ``.pth`` holds
(its ``args``), on the CPU.  ``--output_dir`` defaults to the ``.pth``'s
directory, so that JAX's driver started there with the same flags
auto-resumes; ``--resume <output_dir>/checkpoints/<e>`` names the step.
The grain position holds the JAX run's pack paths and worker count, which
grain checks: ``--data_path`` is the directory the JAX run reads its pack
from (its ``--processed_dir``, else its ``--data_dir``), spelt as that run
will be given it (default: the ``.pth``'s), ``--num_workers`` the JAX run's
(default: the ``.pth``'s); the JAX run's batch a process (``--batch_size``
times its local devices) must be the port's batch a rank, and its process
count the port's rank count.  Prints one JSON line a directory written.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mmearth_tpu_torch.checkpoints import orbax_io, pth_io  # noqa: E402
from mmearth_tpu_torch.checkpoints.convert import flax_converter  # noqa: E402


def _flags(parser, saved: dict) -> argparse.Namespace:
    args = parser.parse_args([])
    for k, v in saved.items():
        setattr(args, k, v)
    return args


def _first(sd: dict, keys: tuple[str, ...], dim: int) -> int:
    for k in keys:
        if k in sd:
            return int(sd[k].shape[dim])
    raise ValueError(f"the checkpoint holds none of {keys}")


def rebuild(ckpt: dict, with_optimizer: bool = True):
    """(model, optimizer or None, flags) of a port checkpoint, from its
    ``args``: the pretraining FCMAE and its AdamW, or the finetune's model
    (its input channels and classes read off the weights) and the
    optimizer of the phase the checkpoint was saved in (the probe's, the
    finetune's, or a staged run's unfrozen one from ``unfreeze_epoch`` on),
    each holding the checkpoint's state."""
    from mmearth_tpu_torch import main_finetune, main_pretrain
    from mmearth_tpu_torch.data.geobench import TASK_CLASS
    from mmearth_tpu_torch.train import finetune as tft
    from mmearth_tpu_torch.train.optim import AdamW
    from mmearth_tpu_torch.train.pretrain import build_model

    saved = dict(ckpt.get("args") or {})
    sd = ckpt["model"]
    if "mask_ratio" in saved:
        args = _flags(main_pretrain.get_args_parser(), saved)
        cfg = main_pretrain.config_from_args(args)
        model = build_model(cfg, "cpu")
        opt = AdamW(model.named_parameters(), lambda count: 0.0, cfg.optim.weight_decay,
                    cfg.optim.betas, update_freq=cfg.optim.update_freq,
                    clip_grad=cfg.optim.clip_grad) if with_optimizer else None
    elif "data_set" in saved:
        args = _flags(main_finetune.get_args_parser(), saved)
        cfg = main_finetune.config_from_args(args)
        in_ch = _first(sd, ("initial_conv.0.weight", "stem_orig.0.weight", "conv1.weight",
                            "encoder.conv1.weight"), 1)
        classes = _first(sd, ("head.weight", "fc.weight", "segmentation_head.weight"), 0)
        model = tft.build_finetune_model(cfg, in_ch, classes)
        staged = TASK_CLASS[cfg.data_set] == "segmentation" and cfg.linear_probe
        if staged and int(ckpt.get("epoch", -1)) >= cfg.unfreeze_epoch:
            trainable = tft.full_trainable(model)
        else:
            trainable = (tft.probe_trainable(model) if cfg.linear_probe
                         else tft.full_trainable(model))
        opt = tft.make_optimizer(cfg, model, trainable, 1) if with_optimizer else None
    else:
        raise ValueError("the checkpoint holds no flags of either driver (its 'args'), so its "
                         "model and optimizer cannot be rebuilt")
    model.load_state_dict(pth_io.model_state(sd, model))
    if opt is not None:
        opt.load_state_dict(ckpt["optimizer"])
    return model, opt, args


def _grain_states(ckpt: dict, args, data_path, num_workers) -> list[bytes] | None:
    raw = ckpt.get("loader_state")
    if raw is None or getattr(args, "loader", None) != "grain":
        return None
    processed = Path(args.processed_dir or args.data_dir)
    pack = "train_arrayrecord" + ("_subset" if args.debug else "")
    jax_pack = Path(data_path) / pack if data_path is not None else processed / pack
    meta_file = next((p / "meta.json" for p in (processed / pack, jax_pack)
                      if (p / "meta.json").is_file()), None)
    if meta_file is None:
        raise FileNotFoundError(f"no meta.json of the pack in {processed / pack} or {jax_pack}")
    meta = json.loads(meta_file.read_text())
    workers = args.num_workers if num_workers is None else num_workers
    positions = raw if isinstance(raw, list) else [raw]
    return [orbax_io.grain_state(t.numpy().tobytes(), meta["count"], meta["shards"], jax_pack,
                                 args.batch_size, 0 if workers <= 1 else workers)
            for t in positions]


def convert(path: str | Path, output_dir: str | Path | None = None, data_path=None,
            num_workers: int | None = None) -> list[dict]:
    """Write the Orbax form of the ``.pth`` at ``path`` (or of a run
    directory's newest numbered one and its ``checkpoint-best.pth``);
    returns a record a directory written: its path, the bytes of its
    files, the seconds spent writing them and the seconds of the whole
    conversion (the ``.pth`` read, the model rebuilt, the trees made)."""
    path = Path(path)
    if path.is_dir():
        found = pth_io.numbered_checkpoints(path)
        files = ([found[-1][1]] if found else []) + [
            p for p in [path / "checkpoint-best.pth"] if p.is_file()]
        if not files:
            raise FileNotFoundError(f"{path}: no checkpoint-<epoch>.pth or checkpoint-best.pth")
    else:
        files = [path]
    records = []
    for f in files:
        ckpt = pth_io.load(f)
        out = Path(output_dir) if output_dir is not None else f.parent
        t0 = time.perf_counter()
        orbax_io.WriteStats.reset()
        if "optimizer" in ckpt:
            model, opt, args = rebuild(ckpt)
            written = orbax_io.save(out, int(ckpt["epoch"]), model, opt, vars(args),
                                    ema=ckpt.get("ema"),
                                    loader_state=_grain_states(ckpt, args, data_path,
                                                               num_workers), keep=0)
        else:
            model, _, _ = rebuild(ckpt, with_optimizer=False)
            written = orbax_io.save_params(out / f.stem, flax_converter(model)(
                model.state_dict())[0])
        records.append({"from": str(f), "wrote": str(written),
                        "bytes": orbax_io.WriteStats.bytes_written,
                        "write_seconds": orbax_io.WriteStats.seconds,
                        "seconds": time.perf_counter() - t0})
    return records


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="a port checkpoint .pth, or a run's output directory")
    p.add_argument("--output_dir", default=None,
                   help="where the Orbax directories go (default: the .pth's directory)")
    p.add_argument("--data_path", default=None,
                   help="the JAX run's --processed_dir (else --data_dir), for the grain position")
    p.add_argument("--num_workers", default=None, type=int,
                   help="the JAX run's --num_workers, for the grain position")
    a = p.parse_args(argv)
    for record in convert(a.path, a.output_dir, a.data_path, a.num_workers):
        print(json.dumps(record))


if __name__ == "__main__":
    main()

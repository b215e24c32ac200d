"""Reconstruction panels (port of ``mmearth_tpu/eval/visualize.py``;
reference visualize_masking.py:58-330).

Runs one batch through a pretrained FCMAE and renders, per pixel modality,
the original / masked / reconstruction / reconstruction-pasted-with-visible
panels, with categorical colormaps for dynamic_world and esa_worldcover.

    python -m mmearth_tpu_torch.eval.visualize --device cuda --ckpt pt.pth \\
        --data_dir <packed split> --out panels/

``render_panels`` needs ``matplotlib``; where it is missing it raises before
it writes anything.  Without ``--data_dir`` the batch comes from a synthetic
MMEarth HDF5 written to a temporary directory, which needs ``h5py``.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..losses.multipretext import unpatchify
from ..models import fcmae as fcmae_lib

DW_COLORS = np.array([
    [65, 155, 223], [57, 125, 73], [136, 176, 83], [122, 135, 198],
    [228, 150, 53], [223, 195, 90], [196, 40, 27], [165, 155, 143], [179, 159, 225],
]) / 255.0

ESA_COLORS = np.array([
    [0, 100, 0], [255, 187, 34], [255, 255, 76], [240, 150, 255], [250, 0, 0],
    [180, 180, 180], [240, 240, 240], [0, 100, 200], [0, 150, 160], [0, 207, 117],
    [250, 230, 160],
]) / 255.0

PANEL_SAMPLES = 4  # the CLI's batch (JAX's visualize.py:134-151)


@torch.no_grad()
def run_one_batch(model: fcmae_lib.FCMAE, batch, mask=None,
                  generator: torch.Generator | None = None):
    """Returns (maps, mask): each pixel modality's reconstruction as an
    (N, H, W, C) f32 numpy map, and the (N, L) mask (1 = removed).  The
    batch (numpy arrays or tensors at the model's ``img_size``) goes to the
    model's device.  ``mask`` is used as given; else it is drawn from
    ``generator`` (one on the model's device; seed 0 when None)."""
    dev = next(model.parameters()).device
    batch = fcmae_lib.zero_nan_inputs({k: torch.as_tensor(np.asarray(v)).to(dev)
                                       for k, v in batch.items() if k != "id"})
    imgs = batch["sentinel2"].to(model.dtype)
    if mask is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        mask = fcmae_lib.gen_random_mask(imgs.shape[0], model.num_patches, model.mask_ratio,
                                         generator, device=dev)
    elif not isinstance(mask, torch.Tensor):
        mask = np.array(mask, np.float32)
    mask = torch.as_tensor(mask, dtype=torch.float32, device=dev)
    k = model.num_visible
    if not bool(((mask == 0).sum(1) == k).all()):
        k = None  # not num_visible kept in every row: the masked-dense encoder
    preds = model.forward_decoder(model.encoder.encode(imgs, mask, k), mask)
    maps = {name: unpatchify(p.float(), model.patch_size, model.img_size,
                             model.out_chans[name]).cpu().numpy()
            for name, p in preds.items() if p.ndim == 3}  # (N, L, p*p*C): pixel modalities
    return maps, mask.cpu().numpy()


def render_panels(model, batch, maps, mask, out_dir, sample: int = 0, rgb_bands=(3, 2, 1)):
    """Save original/masked/recon/recon+visible panels, one PNG per pixel
    modality of ``maps`` that the batch holds; returns ``out_dir``.  Imports
    matplotlib first: where it is missing the ImportError names it and
    nothing is written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    g = model.img_size // model.patch_size
    keep_pix = 1.0 - np.repeat(
        np.repeat(np.asarray(mask).reshape(-1, g, g), model.patch_size, 1), model.patch_size, 2
    )[sample][..., None]

    def to_rgb(name, arr):
        if name == "dynamic_world":
            lab = np.clip(np.round(arr[..., 0] if arr.ndim == 3 else arr.argmax(-1)), 0, 8).astype(int)
            return DW_COLORS[lab]
        if name == "esa_worldcover":
            lab = np.clip(np.round(arr[..., 0] if arr.ndim == 3 else arr.argmax(-1)), 0, 10).astype(int)
            return ESA_COLORS[lab]
        if arr.shape[-1] >= 3:
            img = arr[..., list(rgb_bands)]
        else:
            img = np.repeat(arr[..., :1], 3, axis=-1)
        lo, hi = np.nanpercentile(img, 2), np.nanpercentile(img, 98)
        return np.clip((img - lo) / max(hi - lo, 1e-6), 0, 1)

    for name, recon in maps.items():
        if name not in batch:
            continue
        orig = np.asarray(batch[name][sample]).astype(np.float32)
        rec = recon[sample]
        if name in ("dynamic_world", "esa_worldcover"):
            rec_lab = rec.reshape(*rec.shape[:2], -1, model.out_chans[name]).mean(2).argmax(-1)
            rec_img = to_rgb(name, np.eye(model.out_chans[name])[rec_lab])
        else:
            rec_img = to_rgb(name, rec)
        orig_img = to_rgb(name, orig)
        masked_img = orig_img * keep_pix
        paste = rec_img * (1 - keep_pix) + orig_img * keep_pix

        fig, axes = plt.subplots(1, 4, figsize=(12, 3))
        for ax, img, title in zip(axes, [orig_img, masked_img, rec_img, paste],
                                  ["original", "masked", "reconstruction", "recon + visible"]):
            ax.imshow(img)
            ax.set_title(title)
            ax.axis("off")
        fig.suptitle(name)
        fig.savefig(out_dir / f"{name}.png", dpi=100, bbox_inches="tight")
        plt.close(fig)
    return out_dir


def load_batch(data_dir: str | None, img_size: int) -> dict[str, np.ndarray]:
    """The first ``PANEL_SAMPLES`` samples of the packed split at
    ``data_dir``, or of a synthetic MMEarth HDF5 (which needs h5py) written
    to a temporary directory, cropped to ``img_size``."""
    from ..configs import modalities as M

    def crop(v):
        return v[:, :img_size, :img_size] if v.ndim == 4 else v

    if data_dir:
        from ..data.loader import PackedDataset, PackedLoader

        loader = PackedLoader(PackedDataset(data_dir), batch_size=PANEL_SAMPLES, shuffle=False,
                              drop_last=False, prefetch=0)
        return {k: crop(np.asarray(v)) for k, v in next(iter(loader)).items()}
    import tempfile

    from ..data.mmearth import MMEarthDataset, require_h5py
    from ..data.synthetic import generate

    require_h5py()
    with tempfile.TemporaryDirectory() as tmp:
        root = generate(tmp, n=2 * PANEL_SAMPLES, tile=max(64, img_size))
        ds = MMEarthDataset(root, {**M.INP_MODALITIES, **M.OUT_MODALITIES}, split="train")
        items = [ds[i] for i in range(PANEL_SAMPLES)]
        return {k: crop(np.stack([it[k] for it in items])) for k in items[0] if k != "id"}


def load_fcmae(model: fcmae_lib.FCMAE, path: str | Path) -> None:
    """Load a pretraining checkpoint into ``model``, encoder, decoder and
    heads: a ``.pth`` (the port's, or upstream's Minkowski one), or the JAX
    package's Orbax directory (a step or its payload, or a params
    directory; the whole FCMAE's ``params`` through ``from_jax_fcmae``).
    (The JAX CLI overlays the encoder alone, at the top of the FCMAE's
    tree, where its keys are not found; the panels need the decoder the
    checkpoint trained.)"""
    from ..checkpoints import orbax_io, pth_io
    from ..checkpoints.convert import params_converter

    path = Path(path)
    own = model.state_dict()
    if path.suffix not in (".pth", ".pt") and path.is_dir():
        tree = orbax_io.numpy_tree(orbax_io.load_params(path))
        sd = params_converter(model)(tree.get("params", tree))
    else:
        sd = pth_io.load(path)["model"]
    state = pth_io.model_state(sd, model)
    missing = sorted(set(own) - set(state))
    if missing:
        raise ValueError(f"--ckpt {path}: no {missing[:5]} (not a pretraining checkpoint of "
                         "this model)")
    model.load_state_dict({k: v for k, v in state.items() if k in own})


def main(argv=None):
    """CLI: reconstruction panels from a pretraining checkpoint (random
    weights from ``--seed`` without one) on packed or synthetic data
    (reference visualize_masking.py __main__)."""
    import argparse

    from ..configs import modalities as M
    from ..configs.config import model_size
    from ..train.pretrain import resolve_device

    ap = argparse.ArgumentParser(description="FCMAE reconstruction panels (PyTorch/CUDA)")
    ap.add_argument("--ckpt", default=None, help="pretraining checkpoint (.pth); random "
                                                 "weights if omitted")
    ap.add_argument("--model", default="convnextv2_atto")
    ap.add_argument("--input_size", type=int, default=56)
    ap.add_argument("--patch_size", type=int, default=8)
    ap.add_argument("--mask_ratio", type=float, default=0.6)
    ap.add_argument("--out", default="./visualize")
    ap.add_argument("--data_dir", default=None,
                    help="packed mmearth split; a synthetic HDF5 (needs h5py) if omitted")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="the weights' and the mask's seed")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    depths, dims = model_size(args.model)
    model = fcmae_lib.FCMAE(
        img_size=args.input_size, patch_size=args.patch_size, depths=depths, dims=dims,
        mask_ratio=args.mask_ratio, loss_aggr="unweighted",
        inp_modalities=M.INP_MODALITIES, out_modalities=M.OUT_MODALITIES,
    ).init_weights(torch.Generator().manual_seed(args.seed))
    if args.ckpt:
        load_fcmae(model, args.ckpt)
    model.to(dev).eval()
    batch = load_batch(args.data_dir, args.input_size)
    maps, mask = run_one_batch(model, batch,
                               generator=torch.Generator(device=dev).manual_seed(args.seed))
    out = render_panels(model, batch, maps, mask, args.out)
    print(f"wrote reconstruction panels to {out}")
    return out


if __name__ == "__main__":
    main()

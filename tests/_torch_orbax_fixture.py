"""The committed Orbax fixture of the port's checkpoint reader
(``tests/fixtures/orbax_pretrain_tiny/``), written by the JAX package itself.

A narrow FCMAE (the 12 output modalities; depths 1, stages 24, 24, 24 and 40
wide, widths at which ``tests/test_torch_gpu.py`` holds the gathered dwconv
and spill-g kernels on the card; decoder 8 wide, so that the checkpoint
stays under 2 MB) takes 3 f32 micro-steps of JAX's AdamW under
``MultiSteps`` at ``update_freq`` 2 with the clip on, so it is saved
mid-accumulation, by ``CheckpointIO.save`` as epoch 0.  Beside it
``expected.json`` holds the configuration, a checksum of every leaf, the
batch's checksum (``bench_batch`` from a seed) and the masks, JAX's f32
losses of the next two micro-steps and the encoder's output on the first of
them.  ``chip_smoke.py::phase_orbax`` and ``tests/test_torch_orbax.py`` read
it.

Regenerate it (on a host with JAX) with ``python tests/_torch_orbax_fixture.py``;
``build_state`` is the same run at any size, for the tests.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mmearth_tpu.checkpoints.orbax_io import CheckpointIO  # noqa: E402
from mmearth_tpu.checkpoints.torch_convert import torch_fcmae_to_flax  # noqa: E402
from mmearth_tpu.configs import modalities as JM  # noqa: E402
from mmearth_tpu.models import fcmae as jfc  # noqa: E402
from mmearth_tpu.train import optim as joptim  # noqa: E402
from mmearth_tpu.train.schedule import warmup_cosine  # noqa: E402
from mmearth_tpu.train.step import TrainState  # noqa: E402
from mmearth_tpu_torch.data.synthetic import bench_batch  # noqa: E402
from mmearth_tpu_torch.models.fcmae import FCMAE  # noqa: E402

from _torch_parity import random_mask, randomize_grn  # noqa: E402

FIXTURE = ROOT / "tests" / "fixtures" / "orbax_pretrain_tiny"
CONFIG = {
    "model_size": "fixture",  # the CLI's --model convnextv2_fixture, once registered
    "depths": [1, 1, 1, 1], "dims": [24, 24, 24, 40], "decoder_embed_dim": 8,
    "img_size": 56, "patch_size": 8, "batch_size": 4, "update_freq": 2, "clip_grad": 1.0,
    "weight_decay": 0.05, "betas": [0.9, 0.95],
    # warmup_cosine(base lr, min lr, epochs, warmup epochs, updates an epoch)
    "schedule": [1e-3, 1e-5, 4, 1, 2],
    "micro_steps_saved": 3, "micro_steps_after": 2, "epoch": 0, "batch_seed": 5,
    "mask_seed": 2, "keep": 19,
}


def model_kwargs(cfg: dict) -> dict:
    return dict(img_size=cfg["img_size"], patch_size=cfg["patch_size"],
                depths=tuple(cfg["depths"]), dims=tuple(cfg["dims"]),
                decoder_embed_dim=cfg["decoder_embed_dim"], inp_modalities=JM.INP_MODALITIES,
                out_modalities=JM.OUT_MODALITIES)


def batches_and_masks(cfg: dict):
    """The micro-steps' batches (``bench_batch`` of the seed, in slices) and
    masks (each keeping ``keep`` patches a row)."""
    n = cfg["batch_size"]
    total = cfg["micro_steps_saved"] + cfg["micro_steps_after"]
    data = bench_batch(n * total, cfg["img_size"], seed=cfg["batch_seed"])
    batches = [{k: v[i * n:(i + 1) * n] for k, v in data.items()} for i in range(total)]
    rng = np.random.default_rng(cfg["mask_seed"])
    grid = (cfg["img_size"] // cfg["patch_size"]) ** 2
    masks = [random_mask(rng, n, grid, cfg["keep"]) for _ in range(total)]
    return batches, masks


def batch_digest(batch: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def leaf_digest(a) -> str:
    """sha256 of a leaf's little-endian C-order bytes (bfloat16 as its bits)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def build_state(cfg: dict = CONFIG, seed: int = 0):
    """JAX's model, the state after ``micro_steps_saved`` micro-steps, its
    jitted micro-step and loss, and the batches and masks of the run."""
    jm = jfc.FCMAE(**model_kwargs(cfg))
    init = FCMAE(**model_kwargs(cfg)).init_weights(torch.Generator().manual_seed(seed))
    params = torch_fcmae_to_flax({k: v.numpy().copy() for k, v in init.state_dict().items()},
                                 tuple(cfg["depths"]), JM.OUT_MODALITIES)
    params = randomize_grn(jax.tree_util.tree_map(jnp.asarray, params), seed=1)
    tx = joptim.make_pretrain_optimizer(params, warmup_cosine(*cfg["schedule"]),
                                        cfg["weight_decay"], tuple(cfg["betas"]),
                                        update_freq=cfg["update_freq"],
                                        clip_grad=cfg["clip_grad"])
    state = TrainState.create(params, tx)

    def loss_fn(p, b, m):
        return jm.apply({"params": p}, b, mask=m)[0]

    grad_fn = jax.value_and_grad(loss_fn)

    def step(st, b, m):
        loss, g = grad_fn(st.params, b, m)
        return st.apply_gradients(g), loss

    step = jax.jit(step)
    batches, masks = batches_and_masks(cfg)
    for b, m in zip(batches[:cfg["micro_steps_saved"]], masks):
        state, _ = step(state, jfc.zero_nan_inputs({k: jnp.asarray(v) for k, v in b.items()}),
                        jnp.asarray(m))
    return jm, state, step, batches, masks


def expected(cfg: dict, jm, state, step, batches, masks) -> dict:
    """JAX's losses of the micro-steps after the save, the encoder's output
    on the first of them, and the digests of the batch and the leaves."""
    k = cfg["micro_steps_saved"]
    first = jfc.zero_nan_inputs({n: jnp.asarray(v) for n, v in batches[k].items()})
    enc, _ = jm.apply({"params": state.params}, first["sentinel2"], 0.6, True,
                      jnp.asarray(masks[k]), method=jm.forward_encoder)
    losses = []
    st = state
    for b, m in zip(batches[k:], masks[k:]):
        st, loss = step(st, jfc.zero_nan_inputs({n: jnp.asarray(v) for n, v in b.items()}),
                        jnp.asarray(m))
        losses.append(float(loss))
    return {"losses_after": losses,
            "encoder_output": {"shape": list(enc.shape), "f32_base64": base64.b64encode(
                np.ascontiguousarray(enc, "<f4").tobytes()).decode()},
            "batch_sha256": [batch_digest(b) for b in batches],
            "masks": [["".join(str(int(v)) for v in row) for row in m] for m in masks]}


def leaf_digests(tree) -> dict:
    """``"a.b.c"`` -> [dtype, shape, sha256] of every array leaf."""
    from mmearth_tpu_torch.checkpoints.convert import tree_leaves

    out = {}
    for path, leaf in tree_leaves(tree):
        if leaf is None:
            continue
        dtype = "bfloat16" if isinstance(leaf, torch.Tensor) else str(np.asarray(leaf).dtype)
        out[".".join(map(str, path))] = [dtype, list(np.shape(leaf)), leaf_digest(leaf)]
    return out


def main() -> None:
    from mmearth_tpu_torch.checkpoints import orbax_io

    jm, state, step, batches, masks = build_state()
    shutil.rmtree(FIXTURE, ignore_errors=True)
    io = CheckpointIO(FIXTURE, max_to_keep=1)
    io.save(CONFIG["epoch"], state)
    io.wait()
    # the digests are of what the JAX package reads back
    from mmearth_tpu.checkpoints.orbax_io import load_params

    tree = jax.tree_util.tree_map(np.asarray, load_params(
        FIXTURE / "checkpoints" / str(CONFIG["epoch"]) / "default"))
    record = {"config": CONFIG, "leaves": leaf_digests(tree),
              **expected(CONFIG, jm, state, step, batches, masks)}
    assert leaf_digests(orbax_io.load_tree(FIXTURE / "checkpoints" / "0")) == record["leaves"]
    (FIXTURE / "expected.json").write_text(json.dumps(record, separators=(",", ":")) + "\n")
    size = sum(p.stat().st_size for p in FIXTURE.rglob("*") if p.is_file())
    print(f"wrote {FIXTURE} ({size} bytes), losses {record['losses_after']}")


if __name__ == "__main__":
    main()

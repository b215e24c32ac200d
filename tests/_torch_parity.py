"""Shared helpers of the tests that hold the PyTorch port (``mmearth_tpu_torch``)
against the JAX package: inputs made with numpy from a seed, JAX params
carried into the port through its own converter, and comparison of
state-dict-shaped gradients."""
from __future__ import annotations

import jax
import numpy as np
import torch

from mmearth_tpu_torch.checkpoints.convert import from_jax_encoder, from_jax_fcmae, to_tensors


def np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def random_mask(rng: np.random.Generator, n: int, num_patches: int, keep: int) -> np.ndarray:
    """(N, L) float32 mask (1 = removed) with exactly ``keep`` zeros per row."""
    mask = np.ones((n, num_patches), np.float32)
    for i in range(n):
        mask[i, rng.permutation(num_patches)[:keep]] = 0.0
    return mask


def randomize_grn(params, seed: int = 0):
    """Non-identity GRN affines (they init to zero, which hides GRN bugs)."""
    rng = np.random.default_rng(seed)

    def fix(path, leaf):
        keys = [str(getattr(p, "key", p)) for p in path]
        if "grn" in keys:
            return jax.numpy.asarray(0.5 * rng.normal(size=leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(fix, params)


def encoder_grads_as_sd(grads, depths):
    return to_tensors(from_jax_encoder(np_tree(grads), depths))


def fcmae_grads_as_sd(grads, depths, out_modalities):
    return from_jax_fcmae(np_tree(grads), depths, out_modalities)


def assert_grads_close(port_module: torch.nn.Module, ref_sd: dict, rtol: float, prefix: str = ""):
    """Each param's .grad against the reference, relative to the reference's
    largest magnitude (atol = rtol * max|ref|)."""
    seen = 0
    for name, prm in port_module.named_parameters():
        key = prefix + name
        if key not in ref_sd:
            continue
        ref = ref_sd[key].reshape(prm.shape)
        got = prm.grad if prm.grad is not None else torch.zeros_like(prm)
        scale = float(ref.abs().max()) or 1.0
        np.testing.assert_allclose(got.detach().numpy(), ref.numpy(), rtol=rtol,
                                   atol=rtol * scale, err_msg=key)
        seen += 1
    assert seen > 0

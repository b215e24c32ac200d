"""The port's optimizer, schedule and step against the JAX package: a 3-update
f32 trajectory of the small FCMAE with explicit masks, from the same weights,
against ``make_pretrain_optimizer`` (with and without update_freq=2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmearth_tpu.checkpoints.torch_convert import torch_fcmae_to_flax
from mmearth_tpu.configs import modalities as JM
from mmearth_tpu.models import fcmae as jfc
from mmearth_tpu.train import optim as joptim
from mmearth_tpu.train.schedule import warmup_cosine as jax_warmup_cosine
from mmearth_tpu.train.step import TrainState
from mmearth_tpu_torch.checkpoints.convert import from_jax_fcmae
from mmearth_tpu_torch.data.synthetic import synthetic_batch
from mmearth_tpu_torch.models.fcmae import FCMAE
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train.schedule import warmup_cosine
from mmearth_tpu_torch.train.step import pretrain_step

from _torch_parity import np_tree, random_mask

DEPTHS = (1, 1, 1, 1)
KW = dict(img_size=56, patch_size=8, depths=DEPTHS, dims=(8, 16, 32, 64), decoder_embed_dim=32,
          grn_group=2, inp_modalities=JM.INP_MODALITIES, out_modalities=JM.OUT_MODALITIES)
BASE_LR, WD = 1e-3, 0.05


def test_warmup_cosine_matches_jax():
    ours = warmup_cosine(1e-3, 1e-5, 10, 2, 7)
    ref = jax_warmup_cosine(1e-3, 1e-5, 10, 2, 7)
    for step in (0, 3, 14, 15, 40, 69, 70):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6, atol=1e-12)


def test_wd_mask_matches_jax():
    model = FCMAE(**KW)
    params = torch_fcmae_to_flax({k: v.detach().numpy() for k, v in model.state_dict().items()},
                                 DEPTHS, JM.OUT_MODALITIES)
    ref_mask = from_jax_fcmae(jax.tree_util.tree_map(  # each leaf's flag as a leaf-shaped array
        lambda m, p: np.full(np.shape(p), float(m), np.float32),
        joptim.pretrain_wd_mask(params), params), DEPTHS, JM.OUT_MODALITIES)
    ours = toptim.pretrain_wd_mask(model.named_parameters())
    assert ours == {k: bool(ref_mask[k].reshape(-1)[0]) for k in ours}
    assert ours["mask_token"] and ours["encoder.stages.0.0.grn.gamma"]
    assert not ours["loss_fn.log_vars"] and not ours["encoder.stem.1.weight"]


def test_clip_grad_by_global_norm():
    p = torch.nn.Parameter(torch.ones(4))
    opt = toptim.AdamW([("w", p)], lambda step: 0.1, weight_decay=0.0, clip_grad=1.0)
    p.grad = torch.full((4,), 10.0)
    opt.step()
    # clipped to norm 1 then Adam's first step moves every element by lr
    np.testing.assert_allclose(p.detach().numpy(), np.full(4, 0.9), rtol=1e-6)


@pytest.mark.parametrize("update_freq", [1, 2])
def test_three_update_trajectory_matches_jax(update_freq):
    """3 optimizer updates (3 * update_freq micro-steps) of f32 training.
    Params agree within 2e-5 absolute + 1e-4 relative: the grads agree to
    ~1e-5 of their scale, and Adam's first updates (mu_hat / sqrt(nu_hat) ~
    sign(g)) move each param by ~lr regardless of |g|, so a relative grad
    difference shows up as at most ~lr * 1e-2 in the params."""
    n, micro = 2, 3 * update_freq
    rng = np.random.default_rng(update_freq)
    data = synthetic_batch(n * micro, 56, seed=5)
    batches = [{k: v[i * n:(i + 1) * n] for k, v in data.items()} for i in range(micro)]
    masks = [random_mask(rng, n, 49, 19) for _ in range(micro)]

    model = FCMAE(**KW).init_weights(torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, torch_fcmae_to_flax(
        {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}, DEPTHS,
        JM.OUT_MODALITIES))

    sched_args = (BASE_LR, 1e-5, 4, 1, 2)  # 1 warmup epoch of 2 updates
    jm = jfc.FCMAE(**KW)
    tx = joptim.make_pretrain_optimizer(params, jax_warmup_cosine(*sched_args), WD,
                                        update_freq=update_freq)
    state = TrainState.create(params, tx)
    grad_fn = jax.grad(lambda p, b, m: jm.apply({"params": p}, b, mask=m)[0])
    step_fn = jax.jit(lambda st, b, m: st.apply_gradients(grad_fn(st.params, b, m)))
    for b, m in zip(batches, masks):
        jb = jfc.zero_nan_inputs({k: jnp.asarray(v) for k, v in b.items()})
        state = step_fn(state, jb, jnp.asarray(m))

    opt = toptim.AdamW(model.named_parameters(), warmup_cosine(*sched_args), WD,
                       update_freq=update_freq)
    gen = torch.Generator().manual_seed(0)
    for step, (b, m) in enumerate(zip(batches, masks)):
        metrics = pretrain_step(model, opt, {k: torch.from_numpy(v) for k, v in b.items()},
                                step, gen, random_crop=False, mask=torch.from_numpy(m))
        assert np.isfinite(float(metrics["loss"]))
    assert opt.count == 3

    ref = from_jax_fcmae(np_tree(state.params), DEPTHS, JM.OUT_MODALITIES)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref[k].reshape(v.shape).numpy(), rtol=1e-4,
                                   atol=2e-5, err_msg=k)
    init = FCMAE(**KW).init_weights(torch.Generator().manual_seed(0)).state_dict()
    assert max(float((v - init[k]).abs().max()) for k, v in model.state_dict().items()) > 1e-4

"""Chained dispatch in the port (``--steps_per_dispatch``) on the CPU: the
port's ``_chunked_batches`` against JAX's, k steps a dispatch training
exactly as single steps do (epoch loss, step losses, final state; with
``update_freq`` 1 and 2), the draws split out of the step, AdamW's device
lr and bias corrections against the float arithmetic, the CLI's chained
run saving and resuming, and the CPU loader's numpy batches."""
import math

import numpy as np
import pytest
import torch

from mmearth_tpu.data.loader import PackedDataset as JaxPackedDataset
from mmearth_tpu.data.loader import PackedLoader as JaxPackedLoader
from mmearth_tpu.train.pretrain import _chunked_batches as jax_chunked_batches
from mmearth_tpu_torch import main_pretrain
from mmearth_tpu_torch.configs import modalities as M
from mmearth_tpu_torch.configs.config import (DataConfig, ModelConfig, OptimConfig,
                                              PretrainConfig, RunConfig)
from mmearth_tpu_torch.data.synthetic import bench_batch, generate_packed
from mmearth_tpu_torch.models.fcmae import FCMAE, gen_random_mask, mask_from_noise
from mmearth_tpu_torch.train import optim as toptim
from mmearth_tpu_torch.train import pretrain
from mmearth_tpu_torch.train.step import ChainedStep, draw, fold_in, pretrain_step, to_device

KW = dict(img_size=56, patch_size=8, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
          decoder_embed_dim=32, grn_group=2, inp_modalities=M.INP_MODALITIES,
          out_modalities=M.OUT_MODALITIES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    # 12 samples of 64-px tiles: 11 in train, 5 steps of batch 2 (drop_last)
    return generate_packed(tmp_path_factory.mktemp("mmpack"), n=12, tile=64, seed=0)


def _batches(n: int, rng: np.random.Generator) -> list[dict]:
    return [{"sentinel2": rng.normal(size=(2, 4, 4, 3)).astype(np.float32),
             "biome": rng.integers(0, 9, size=(2, 14)).astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("k,n", [(2, 5), (3, 7), (3, 6), (4, 3)])
def test_chunked_batches_match_jax(k, n):
    """Stacked groups of k, then the tail unstacked, as JAX's; torch
    tensors stack the same way."""
    batches = _batches(n, np.random.default_rng(k * 10 + n))
    ours, ref = list(pretrain._chunked_batches(iter(batches), k)), list(
        jax_chunked_batches(iter(batches), k))
    tensors = list(pretrain._chunked_batches(
        ({key: torch.from_numpy(v) for key, v in b.items()} for b in batches), k))
    assert len(ours) == len(ref) == len(tensors) == n // k + n % k
    for a, b, t in zip(ours, ref, tensors):
        assert a.keys() == b.keys() == t.keys()
        for key in a:
            assert a[key].shape == b[key].shape == tuple(t[key].shape)
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(t[key].numpy(), b[key])


def _cfg(data, k: int, update_freq: int, epochs: int = 2) -> PretrainConfig:
    return PretrainConfig(
        model=ModelConfig(model="convnextv2_atto", img_size=56, patch_size=8,
                          decoder_embed_dim=64),
        optim=OptimConfig(update_freq=update_freq, warmup_epochs=1, blr=1e-2),
        data=DataConfig(processed_dir=str(data), batch_size=2),
        run=RunConfig(epochs=epochs, seed=3, use_bf16=False, steps_per_dispatch=k))


@pytest.mark.parametrize("update_freq", [1, 2])
def test_run_pretrain_chained_equals_single_steps(data, update_freq):
    """Two epochs of 5 steps at k = 3 (a dispatch of 3, then a tail of 2
    single steps) against k = 1: the same step losses, epoch means, final
    params and AdamW state, bit for bit.  At update_freq 2 the second
    epoch's chain starts at the other micro-step."""
    runs = {k: pretrain.run_pretrain(_cfg(data, k, update_freq), "cpu") for k in (1, 3)}
    (m1, h1, o1), (m3, h3, o3) = runs[1], runs[3]
    assert [e["steps"] for e in h3] == [5, 5] and [e["chained_steps"] for e in h3] == [3, 3]
    assert [e["chained_steps"] for e in h1] == [0, 0]
    assert [e["step_losses"] for e in h3] == [e["step_losses"] for e in h1]
    assert [e["loss"] for e in h3] == [e["loss"] for e in h1]
    assert all(math.isfinite(v) for e in h3 for v in e["step_losses"])
    assert len({v for e in h1 for v in e["step_losses"]}) == 10  # every step its own draws
    s1, s3 = m1.state_dict(), m3.state_dict()
    assert all(torch.equal(s1[k], s3[k]) for k in s1)
    a, b = o1.state_dict(), o3.state_dict()
    assert (a["count"], a["mini_step"]) == (b["count"], b["mini_step"]) == (10 // update_freq, 0)
    for key in ("mu", "nu", "acc"):
        assert (a[key] is None) == (b[key] is None) == (key == "acc" and update_freq == 1)
        for name in a[key] or ():
            assert torch.equal(a[key][name], b[key][name]), (key, name)


def test_chained_step_on_a_resident_batch_equals_pretrain_steps():
    """The bench's use: a ChainedStep over ``batch.expand(k, ...)`` against k
    pretrain_step calls on the batch, from the same state: the k losses, the
    last step's metrics and the loss sum."""
    batch = to_device(bench_batch(2, 64, seed=1), "cpu")
    out = []
    for chained in (False, True):
        model = FCMAE(**KW).init_weights(torch.Generator().manual_seed(0))
        opt = toptim.AdamW(model.named_parameters(), lambda n: 1e-3 / (1 + n))
        gen = torch.Generator().manual_seed(5)
        loss_sum = torch.zeros(())
        if chained:
            ch = ChainedStep(model, opt, {k: v.expand(3, *v.shape) for k, v in batch.items()})
            metrics, losses = ch(4, gen, loss_sum)
            assert ch.steps == {"eager": 3, "recorded": 0, "replayed": 0}
        else:
            steps = [pretrain_step(model, opt, batch, 4 + i, gen, loss_sum=loss_sum)
                     for i in range(3)]
            metrics, losses = steps[-1], torch.stack([m["loss"] for m in steps])
        out.append((metrics, losses, loss_sum, model.state_dict(), opt.count))
    (m0, l0, s0, p0, c0), (m1, l1, s1, p1, c1) = out
    assert torch.equal(l0, l1) and torch.equal(s0, s1) and c0 == c1 == 3
    assert m0.keys() == m1.keys() and all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (11, 123456)])
def test_draws_equal_the_steps_draws(seed, step):
    """``draw`` gives the crop offsets and mask that the step drew before the
    split: ``fold_in(gen, step)`` read as tops, lefts, then the mask's
    noise; without a crop, the noise alone."""
    model = FCMAE(**KW)
    images = torch.zeros(4, 64, 64, 12)
    gen = torch.Generator().manual_seed(seed)
    g = fold_in(gen, step)
    tops = torch.randint(0, 9, (4,), generator=g)
    lefts = torch.randint(0, 9, (4,), generator=g)
    mask = gen_random_mask(4, 49, 0.6, g)
    d = draw(model, images, step, gen, crop=True)
    assert torch.equal(d.tops, tops) and torch.equal(d.lefts, lefts)
    assert torch.equal(mask_from_noise(d.noise, 0.6), mask)
    assert int((mask == 0).sum(1).unique()) == model.num_visible
    nocrop = draw(model, images, step, gen, crop=False)
    assert nocrop.tops is None and torch.equal(
        mask_from_noise(nocrop.noise, 0.6), gen_random_mask(4, 49, 0.6, fold_in(gen, step)))


def test_forward_from_noise_equals_forward_from_its_mask():
    model = FCMAE(**KW).init_weights(torch.Generator().manual_seed(0))
    batch = to_device(bench_batch(2, 56, seed=2), "cpu")
    noise = torch.randn(2, 49, generator=torch.Generator().manual_seed(4))
    a = model(batch, noise=noise)
    b = model(batch, mask=mask_from_noise(noise, 0.6))
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


def _float_adamw_step(opt, grads, state):
    """The update as it was written with host floats (lr and bias
    corrections as Python scalars, ``alpha=-lr``), the reference of the
    device-tensor path."""
    mu, nu, acc = state["mu"], state["nu"], state["acc"]
    if acc is not None:
        n = state["mini_step"]
        for a, g in zip(acc, grads):
            a.add_((g - a) / (n + 1))
        state["mini_step"] += 1
        if state["mini_step"] < opt.update_freq:
            return
        state["mini_step"] = 0
        grads = [a.clone() for a in acc]
        for a in acc:
            a.zero_()
    if opt.clip_grad is not None:
        norm = toptim.global_norm(grads)
        scale = torch.where(norm < opt.clip_grad, torch.ones_like(norm), opt.clip_grad / norm)
        torch._foreach_mul_(grads, scale)
    b1, b2 = opt.betas
    lr = opt.lr_schedule(state["count"])
    state["count"] += 1
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
    mu_hat = torch._foreach_div(mu, 1 - b1 ** state["count"])
    denom = torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2 ** state["count"]))
    torch._foreach_add_(denom, opt.eps)
    upd = torch._foreach_div(mu_hat, denom)
    dec = [i for i, d in enumerate(opt.decay) if d]
    torch._foreach_add_([upd[i] for i in dec], [state["params"][i] for i in dec],
                        alpha=opt.weight_decay)
    if opt.scales is not None:
        torch._foreach_mul_(upd, opt.scales)
    torch._foreach_add_(state["params"], upd, alpha=-lr)


@pytest.mark.parametrize("update_freq,clip,scaled", [(1, None, False), (2, 0.5, True),
                                                      (3, None, True)])
def test_tensor_lr_adamw_matches_float_arithmetic(update_freq, clip, scaled):
    """Seven steps of random grads: the moments agree bit for bit and the
    params to f32 rounding of the update (lr * update is rounded once more
    than ``add_(alpha=-lr)`` rounds it)."""
    rng = np.random.default_rng(update_freq)
    shapes = {"w": (5, 3), "b": (3,), "k": (2, 1, 7, 7)}
    params = {n: torch.nn.Parameter(torch.from_numpy(rng.normal(size=s).astype(np.float32)))
              for n, s in shapes.items()}
    opt = toptim.AdamW(params.items(), lambda n: 1e-2 * 0.9 ** n, 0.05, (0.9, 0.95),
                       update_freq=update_freq, clip_grad=clip,
                       lr_scales={"w": 0.5, "b": 1.0, "k": 0.25} if scaled else None)
    ref = {"params": [p.detach().clone() for p in params.values()],
           "mu": [torch.zeros(s) for s in shapes.values()],
           "nu": [torch.zeros(s) for s in shapes.values()],
           "acc": [torch.zeros(s) for s in shapes.values()] if update_freq > 1 else None,
           "count": 0, "mini_step": 0}
    for _ in range(7):
        grads = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes.values()]
        for p, g in zip(params.values(), grads):
            p.grad = g.clone()
        opt.step()
        _float_adamw_step(opt, [g.clone() for g in grads], ref)
    assert (opt.count, opt.mini_step) == (ref["count"], ref["mini_step"])
    for mine, theirs in ((opt.mu, ref["mu"]), (opt.nu, ref["nu"]), (opt.acc, ref["acc"])):
        for a, b in zip(mine or (), theirs or ()):
            assert torch.equal(a, b)
    for p, r in zip(params.values(), ref["params"]):
        torch.testing.assert_close(p.detach(), r, rtol=1e-6, atol=1e-8)


def test_adamw_plan_is_the_steps_it_takes():
    """``plan(n)`` reads the next n steps without moving the state, and the
    steps then take them: micro-step, whether each applies, its lr and bias
    corrections."""
    p = torch.nn.Parameter(torch.zeros(2))
    opt = toptim.AdamW([("p", p)], lambda n: 0.1 * (n + 1), update_freq=3)
    opt.mini_step, opt.count = 1, 4
    plan = opt.plan(5)
    assert [(m, a) for m, a, _ in plan] == [(1, False), (2, True), (0, False), (1, False),
                                            (2, True)]
    assert (opt.mini_step, opt.count) == (1, 4)
    b1, b2 = opt.betas
    assert plan[1][2] == [0.1 * 5, 1 - b1 ** 5, 1 - b2 ** 5] and plan[4][2][0] == 0.1 * 6
    for mini, applies, hyper in plan:
        p.grad = torch.ones(2)
        assert opt.step() == applies
        if applies:
            assert torch.equal(opt.hyper, torch.tensor(hyper, dtype=torch.float32))
    assert (opt.mini_step, opt.count) == (0, 6)


def test_main_pretrain_steps_per_dispatch_saves_and_resumes_on_cpu(data, tmp_path):
    """``--steps_per_dispatch 2``: two epochs saved, then ``--epochs 3`` on
    the same directory resumes and runs epoch 2 alone; the same two runs at
    k = 1 give the same losses in every epoch."""
    def args(k, epochs, out):
        return main_pretrain.get_args_parser().parse_args([
            "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
            "--batch_size", "2", "--device", "cpu", "--processed_dir", str(data),
            "--epochs", str(epochs), "--warmup_epochs", "1", "--use_bf16", "False",
            "--decoder_embed_dim", "64", "--steps_per_dispatch", str(k),
            "--output_dir", str(out), "--save_ckpt_num", "2"])

    runs = {}
    for k in (2, 1):
        out = tmp_path / f"k{k}"
        _, first, _ = main_pretrain.main(args(k, 2, out))
        assert [e["epoch"] for e in first] == [0, 1]
        assert [e["chained_steps"] for e in first] == ([4, 4] if k == 2 else [0, 0])
        assert sorted(p.name for p in out.glob("checkpoint-*.pth")) == [
            "checkpoint-0.pth", "checkpoint-1.pth"]
        _, resumed, opt = main_pretrain.main(args(k, 3, out))
        assert [e["epoch"] for e in resumed] == [2] and opt.count == 15
        runs[k] = [(e["step_losses"], e["loss"]) for e in first + resumed]
    assert runs[2] == runs[1]


def test_loader_for_the_cpu_yields_the_numpy_batches(data):
    """``get_dataloader`` on the CPU (``pin_memory`` off) yields numpy
    arrays, the JAX loader's batches on the same pack."""
    cfg = _cfg(data, 3, 1)
    _, loader = pretrain.get_dataloader(cfg)
    ref = JaxPackedLoader(JaxPackedDataset(data / "train"), batch_size=2, shuffle=True,
                          drop_last=True, seed=cfg.run.seed)
    assert not loader.pin_memory
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(loader), list(ref)
        assert len(got) == len(want) == 5
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for key in a:
                assert isinstance(a[key], np.ndarray)
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)

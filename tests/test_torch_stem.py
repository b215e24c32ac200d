"""``ops/stem.py::stem_rows``, the gathered encoder's stem on the visible
patches: its plain version against the JAX package's stem rows on the CPU,
the routes that take it and those that keep the composed stem, and on a
card the kernel pair against the plain version.

The CPU cases import JAX inside the test, so this file also runs on a
machine that has only PyTorch and nvcc (the card's cases, marked ``gpu``):

    python -m pytest tests/test_torch_stem.py -m gpu --noconftest -q

Tolerances.  Against JAX, in f32: 1e-4 of each output's scale (the same
math summed in other orders, as tests/test_torch_encoder_options.py); in
bf16: 2^-6 of the rows' scale and 2^-5 of each gradient's (both sides round
at the same points, but a value that lands near a rounding boundary in one
order of summation goes the other way in the other, and LN's backward
spreads such a step over the site).  The kernel against the plain version
on the card: rows within one bf16 ulp plus 1e-4 of their scale but for at
most 1e-5 of them (at least 2), and all within 2^-6 of their scale (the f32
statistics are summed in another order: where an LN output or the conv
output rounds the other way, the conv output moves by one ulp and LN2
carries that to the row as |LN2 weight| ulp(z) / std(z), many ulps of a row
near 0; 14 of the 24.9 M rows of a batch-512 atto56 stem did); d(y) within 2^-6 of its scale; the
leaves' f32 sums within 1e-3 of each value plus 1e-3 of the leaf's scale in
f32, and 2^-7 and 2^-6 in bf16, where the plain version rounds the taps'
gradients to bf16 as autograd does and the kernel keeps them in f32.
"""
import numpy as np
import pytest
import torch

from mmearth_tpu_torch.models import convnextv2 as tcnx
from mmearth_tpu_torch.ops import stem as st

GRID, K = 7, 19
# (name, image size, patch size, stem width): the benchmark's two configurations
SHAPES = [("atto56", 56, 8, 40), ("tiny112", 112, 16, 96)]
LEAVES = ("ln1_w", "ln1_b", "tap_w", "tap_b", "ln2_w", "ln2_b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(img: int, patch: int, c: int, n: int, seed: int):
    """numpy inputs: the conv output y (N, img, img, C), a mask of K visible
    patches a sample, the six leaves (non-identity LN affines) and a
    cotangent of the rows."""
    rng = np.random.default_rng(seed)
    s = patch // 8
    mask = np.ones((n, GRID * GRID), np.float32)
    for i in range(n):
        mask[i, rng.permutation(GRID * GRID)[:K]] = 0.0
    leaves = {"ln1_w": 1 + 0.5 * rng.normal(size=c), "ln1_b": 0.5 * rng.normal(size=c),
              "tap_w": rng.normal(size=(c, 1, s, s)), "tap_b": 0.5 * rng.normal(size=c),
              "ln2_w": 1 + 0.5 * rng.normal(size=c), "ln2_b": 0.5 * rng.normal(size=c)}
    y = rng.normal(size=(n, img, img, c)) + rng.normal(size=c)
    r = rng.normal(size=(n, K, 8, 8, c))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(y), mask, {k: f32(v) for k, v in leaves.items()}, f32(r), s


def _port(y, mask, leaves, r, s, dtype, device="cpu"):
    """The port's rows and the gradients of sum(rows * r): (rows, dy, leaf
    gradients), as f32 tensors on the CPU."""
    dev = torch.device(device)
    kept, inv = tcnx.visible_ids(torch.from_numpy(mask).to(dev), K)
    yt = torch.from_numpy(y).to(dev, dtype).requires_grad_(True)
    lt = {k: torch.from_numpy(v).to(dev).requires_grad_(True) for k, v in leaves.items()}
    rows = st.stem_rows(yt, kept, inv, GRID, s, *(lt[k] for k in LEAVES))
    (rows.float() * torch.from_numpy(r).to(dev)).sum().backward()
    cpu = lambda t: t.detach().float().cpu()  # noqa: E731
    return cpu(rows), cpu(yt.grad), {k: cpu(lt[k].grad) for k in LEAVES}


def _jax_rows(img: int, patch: int, c: int, y, mask, leaves, r, dtype: str):
    """JAX's stem rows (``stem_gathered``, convnextv2.py:758-765, through the
    package's own LayerNorm, GELU and depthwise conv submodules) and the
    gradients of sum(rows * r), as numpy f32."""
    import jax
    import jax.numpy as jnp

    from mmearth_tpu.models import convnextv2 as jcnx

    jdt = getattr(jnp, dtype)
    model = jcnx.ConvNeXtV2(patch_size=patch, img_size=img, depths=(1, 1, 1, 1),
                            dims=(c, 2 * c, 4 * c, 8 * c), dtype=jdt, sparse=True,
                            stem_gathered=True)
    n, p, s = y.shape[0], img // GRID, patch // 8
    kept = np.argsort(mask, axis=1, kind="stable")[:, :K]

    def rows_of(mod, yy):
        xg = yy.reshape(n, GRID, p, GRID, p, c).transpose(0, 1, 3, 2, 4, 5)
        xg = xg.reshape(n, GRID * GRID, p, p, c)[np.arange(n)[:, None], kept]
        xg = jcnx.gelu(mod.initial_conv_norm(xg))
        z = mod.stem_norm(mod.stem_conv(xg.reshape(n * K, p, p, c)))
        return z.reshape(n, K, p // s, p // s, c)

    params = {"initial_conv_norm": {"scale": leaves["ln1_w"], "bias": leaves["ln1_b"]},
              "stem_conv": {"kernel": leaves["tap_w"].transpose(2, 3, 1, 0),
                            "bias": leaves["tap_b"]},
              "stem_norm": {"scale": leaves["ln2_w"], "bias": leaves["ln2_b"]}}

    def loss(prm, yy):
        z = model.apply({"params": prm}, yy, method=rows_of)
        return jnp.sum(z.astype(jnp.float32) * r), z

    (_, z), (g, dy) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(y, jdt))
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    grads = {"ln1_w": g["initial_conv_norm"]["scale"], "ln1_b": g["initial_conv_norm"]["bias"],
             "tap_w": g["stem_conv"]["kernel"].transpose(3, 2, 0, 1),
             "tap_b": g["stem_conv"]["bias"],
             "ln2_w": g["stem_norm"]["scale"], "ln2_b": g["stem_norm"]["bias"]}
    return f32(z), f32(dy), {k: f32(v) for k, v in grads.items()}


def _removed(mask, img: int):
    """(N, img, img) bools: the sites of removed patches."""
    p = img // GRID
    m = mask.reshape(-1, GRID, GRID)
    return np.repeat(np.repeat(m, p, 1), p, 2) > 0


def _close(got, ref, rtol, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=rtol,
                               atol=rtol * max(float(np.abs(ref).max()), 1e-6), err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,img,patch,c", SHAPES)
def test_plain_matches_jax(name, img, patch, c, dtype):
    """The plain version (the op on a CPU tensor) against JAX's stem rows at
    the configuration's stem (s = 1, C = 40 at atto56; s = 2, C = 96 at
    tiny112), batch 2: the rows, d(y) with zeros at removed patches, and
    the six leaves' gradients."""
    pytest.importorskip("jax")
    y, mask, leaves, r, s = _case(img, patch, c, 2, seed=img + c)
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        y = torch.from_numpy(y).bfloat16().float().numpy()
    rows, dy, grads = _port(y, mask, leaves, r, s, getattr(torch, dtype))
    ref_rows, ref_dy, ref_grads = _jax_rows(img, patch, c, y, mask, leaves, r, dtype)
    rtol_rows, rtol_grad = (1e-4, 1e-4) if dtype == "float32" else (2 ** -6, 2 ** -5)
    _close(rows, ref_rows, rtol_rows, f"{name} rows")
    _close(dy, ref_dy, rtol_grad, f"{name} dy")
    assert not dy.numpy()[_removed(mask, img)].any()
    for k in LEAVES:
        _close(grads[k], ref_grads[k], rtol_grad, f"{name} {k}")


# (route, ConvNeXtV2 options, encode's num_visible or None for the classifier):
# whether the gathered stem runs through stem_rows
ROUTES = [
    ("gathered", {}, K, True),
    ("gathered_stem_gathered", {"stem_gathered": True}, K, True),
    ("gathered_spillg", {"block_impl": "wholeblock"}, K, True),
    ("masked_dense", {"sparse_impl": "masked_dense"}, K, False),
    ("gathered_without_num_visible", {}, None, False),
    ("leaky_dense", {"sparse": False}, K, False),
    ("use_orig_stem", {"use_orig_stem": True}, K, False),
    ("use_orig_stem_gathered", {"use_orig_stem": True, "stem_gathered": True}, K, False),
    ("gelu_approx", {"gelu_approx": True}, K, False),
    ("classifier", {"sparse": False, "num_classes": 5}, "classifier", False),
]


@pytest.mark.parametrize("route,opts,num_visible,takes", ROUTES, ids=[r[0] for r in ROUTES])
def test_routes(monkeypatch, route, opts, num_visible, takes):
    """The gathered encoder's 3x3-conv stem with the erf GELU calls
    ``stem_rows`` once a forward, whatever ``stem_gathered`` and
    ``block_impl`` say; the masked-dense and leaky encoders, the classifier,
    the original stem and the tanh GELU keep the composed stem and never
    call it."""
    calls = []

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return st.stem_rows(*args, **kw)

    monkeypatch.setattr(tcnx, "stem_rows", counted)
    m = tcnx.ConvNeXtV2(patch_size=8, img_size=56, depths=(1, 1, 1, 1), dims=(8, 16, 32, 64),
                        **opts)
    m.init_weights(torch.Generator().manual_seed(0))
    assert m.stem_kernel == (not opts.get("use_orig_stem") and not opts.get("gelu_approx"))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 56, 56, 12)).astype(np.float32))
    mask = np.ones((2, GRID * GRID), np.float32)
    for i in range(2):
        mask[i, rng.permutation(GRID * GRID)[:K]] = 0.0
    if num_visible == "classifier":
        out = m(x)
    else:
        out = m.encode(x, torch.from_numpy(mask), num_visible=num_visible)
    out.float().sum().backward()
    assert len(calls) == int(takes), route
    if takes:
        assert calls == [(2, 56, 56, 8)]


def test_supported_widths():
    """Every catalog stem width at strides 1 and 2 takes the kernels, with a
    lane plan that covers its channels (atto56's: four lanes a site, five
    pairs a lane; tiny112's: sixteen and three, no lane idle); odd widths,
    widths past ``MAX_C`` and stride 4 compose."""
    for c in (8, 40, 48, 64, 80, 96, 128, 192, 352):
        assert st.supported(c, 1) and st.supported(c, 2)
        for taps in (1, 4):
            group, pairs = st.lane_plan(c, taps)
            assert group in st.GROUPS and 1 <= pairs <= st.MAX_PAIRS
            assert 2 * group * pairs >= c > 2 * group * (pairs - 1)
    assert st.lane_plan(40, 1) == (4, 5) and st.lane_plan(96, 4) == (16, 3)
    assert not st.supported(37, 1) and not st.supported(st.MAX_C + 2, 1)
    assert not st.supported(40, 4)
    assert not tcnx.ConvNeXtV2(patch_size=32, img_size=224).stem_kernel


def _kernel_vs_plain(img, patch, c, dtype, n):
    """(mask, the kernels' (rows, dy, leaf gradients), the plain version's on
    the same card and inputs)."""
    dev = torch.device("cuda")
    y, mask, leaves, r, s = _case(img, patch, c, n, seed=img + c)
    dt = getattr(torch, dtype)
    got = _port(y, mask, leaves, r, s, dt, "cuda")
    # the plain version on the same card, on the same inputs
    kept, _ = tcnx.visible_ids(torch.from_numpy(mask).to(dev), K)
    yt = torch.from_numpy(y).to(dev, dt).requires_grad_(True)
    lt = {k: torch.from_numpy(v).to(dev).requires_grad_(True) for k, v in leaves.items()}
    rows = st.stem_rows_plain(yt, kept, GRID, s, *(lt[k] for k in LEAVES))
    (rows.float() * torch.from_numpy(r).to(dev)).sum().backward()
    ref = (rows.detach().float().cpu(), yt.grad.float().cpu(),
           {k: lt[k].grad.cpu() for k in LEAVES})
    return mask, got, ref


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,img,patch,c", SHAPES)
def test_kernel_matches_plain_on_gpu(monkeypatch, name, img, patch, c, dtype):
    """The kernel pair against the plain version on the card at both
    configurations' stems, batch 8, one launch each way."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # the plain f32 conv
    before = dict(st.LAUNCHES)
    mask, (rows, dy, grads), (ref_rows, ref_dy, ref_grads) = _kernel_vs_plain(
        img, patch, c, dtype, 8)
    assert {k: st.LAUNCHES[k] - before[k] for k in before} == {"stem_rows_fwd": 1,
                                                               "stem_rows_bwd": 1}
    scale = float(ref_rows.abs().max())
    if dtype == "bfloat16":
        ulp = torch.exp2(torch.floor(torch.log2(ref_rows.abs().clamp_min(1e-30))) - 7)
        past = int(((rows - ref_rows).abs() > ulp + 1e-4 * scale).sum())
        assert past <= max(2, 1e-5 * rows.numel()), (name, past)
        assert float((rows - ref_rows).abs().max()) <= 2 ** -6 * scale, name
        tol_dy, rel, frac = 2 ** -6, 2 ** -7, 2 ** -6
    else:
        torch.testing.assert_close(rows, ref_rows, rtol=1e-5, atol=1e-5 * scale)
        tol_dy, rel, frac = 1e-4, 1e-3, 1e-3
    assert float((dy - ref_dy).abs().max()) <= tol_dy * float(ref_dy.abs().max()), name
    assert not dy.numpy()[_removed(mask, img)].any(), name
    for k in LEAVES:
        torch.testing.assert_close(grads[k], ref_grads[k], rtol=rel,
                                   atol=frac * float(ref_grads[k].abs().max()), msg=k)


@pytest.mark.gpu
def test_kernel_in_cuda_graph_on_gpu():
    """Forward and backward captured in a CUDA graph and replayed on new
    inputs give what eager launches give on them, bit for bit (the leaves'
    sums are added in a fixed order), and the replay records no launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    dev, dt = torch.device("cuda"), torch.bfloat16
    y, mask, leaves, r, s = _case(112, 16, 96, 4, seed=5)
    kept, inv = tcnx.visible_ids(torch.from_numpy(mask).to(dev), K)
    yt = torch.from_numpy(y).to(dev, dt).requires_grad_(True)
    lt = {k: torch.from_numpy(v).to(dev).requires_grad_(True) for k, v in leaves.items()}
    rt = torch.from_numpy(r).to(dev)

    def step():
        for t in (yt, *lt.values()):
            t.grad = None
        rows = st.stem_rows(yt, kept, inv, GRID, s, *(lt[k] for k in LEAVES))
        (rows.float() * rt).sum().backward()
        return rows.detach().clone(), yt.grad.clone(), [lt[k].grad.clone() for k in LEAVES]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # warm-up: build, plans
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    with torch.no_grad():
        yt.copy_(torch.randn_like(yt, dtype=torch.float32).to(dt))
        rt.copy_(torch.randn_like(rt))
    before = dict(st.LAUNCHES)
    graph.replay()
    torch.cuda.synchronize()
    assert st.LAUNCHES == before
    want = step()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    for a, b in zip(out[2], want[2]):
        assert torch.equal(a, b)

"""Weights carried across: a JAX FCMAE, classifier, U-Net or ResNet param tree
-> the port's state dict.

``from_jax_fcmae`` takes the flax param tree as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``) and returns upstream's dense
FCMAE state dict, the keys and shapes ``mmearth_tpu.checkpoints.torch_convert
.flax_fcmae_to_torch(target="fcmae")`` emits, which strict-loads into
:class:`mmearth_tpu_torch.models.fcmae.FCMAE`.  Layouts: flax Dense ``(in,
out)`` -> Linear ``(out, in)``; conv HWIO -> OIHW (so the depthwise ``(7, 7,
1, C)`` -> ``(C, 1, 7, 7)``); GRN affines -> ``(1, 1, 1, C)``; the mask token
-> ``(1, D, 1, 1)``; the shared decoder written under every modality name.

The state dicts are whole.  A model split over a grid with a ``model`` axis
takes one as a whole model does, then ``parallel/mesh.py::shard_params``;
one already split takes it through ``mesh.place_state``.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

IMAGE_LEVEL = ("biome", "eco_region", "lat", "lon", "month", "era5")


def _oihw(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def _block(tree: Mapping, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.dwconv.weight"] = _oihw(tree["dwconv"]["kernel"])
    sd[f"{prefix}.dwconv.bias"] = tree["dwconv"]["bias"]
    sd[f"{prefix}.norm.weight"] = tree["norm"]["scale"]
    sd[f"{prefix}.norm.bias"] = tree["norm"]["bias"]
    sd[f"{prefix}.pwconv1.weight"] = _t(tree["pwconv1"]["kernel"])
    sd[f"{prefix}.pwconv1.bias"] = tree["pwconv1"]["bias"]
    sd[f"{prefix}.grn.gamma"] = np.asarray(tree["grn"]["gamma"]).reshape(1, 1, 1, -1)
    sd[f"{prefix}.grn.beta"] = np.asarray(tree["grn"]["beta"]).reshape(1, 1, 1, -1)
    sd[f"{prefix}.pwconv2.weight"] = _t(tree["pwconv2"]["kernel"])
    sd[f"{prefix}.pwconv2.bias"] = tree["pwconv2"]["bias"]


def from_jax_encoder(enc: Mapping, depths: Sequence[int], prefix: str = "") -> dict:
    """JAX ConvNeXtV2 encoder params -> state dict of the port's ConvNeXtV2
    (numpy values, keys under ``prefix``).  The original stem (``stem_orig_*``
    in JAX) takes upstream's ``stem_orig.{0,1}`` keys."""
    sd: dict[str, np.ndarray] = {}
    p = prefix
    orig = "stem_orig_conv" in enc
    convs = ((("stem_orig_conv", "stem_orig.0"),) if orig else
             (("initial_conv_conv", "initial_conv.0"), ("stem_conv", "stem.0")))
    norms = ((("stem_orig_norm", "stem_orig.1"),) if orig else
             (("initial_conv_norm", "initial_conv.1"), ("stem_norm", "stem.1")))
    for name, key in convs:
        sd[f"{p}{key}.weight"] = _oihw(enc[name]["kernel"])
        sd[f"{p}{key}.bias"] = enc[name]["bias"]
    for name, key in norms:
        sd[f"{p}{key}.weight"] = enc[name]["scale"]
        sd[f"{p}{key}.bias"] = enc[name]["bias"]
    for i in range(3):
        sd[f"{p}downsample_layers.{i}.0.weight"] = enc[f"downsample_norms_{i}"]["scale"]
        sd[f"{p}downsample_layers.{i}.0.bias"] = enc[f"downsample_norms_{i}"]["bias"]
        sd[f"{p}downsample_layers.{i}.1.weight"] = _oihw(enc[f"downsample_convs_{i}"]["kernel"])
        sd[f"{p}downsample_layers.{i}.1.bias"] = enc[f"downsample_convs_{i}"]["bias"]
    for i, depth in enumerate(depths):
        for j in range(depth):
            _block(enc[f"stages_{i}_{j}"], f"{p}stages.{i}.{j}", sd)
    return sd


def from_jax_classifier(tree: Mapping, depths: Sequence[int]) -> dict[str, torch.Tensor]:
    """JAX dense ConvNeXtV2 classifier params -> state dict of the port's
    ``ConvNeXtV2(sparse=False)``: the encoder trunk plus ``norm.*`` and
    ``head.*``."""
    sd = from_jax_encoder(tree, depths)
    sd["norm.weight"] = tree["norm"]["scale"]
    sd["norm.bias"] = tree["norm"]["bias"]
    sd["head.weight"] = _t(tree["head"]["kernel"])
    sd["head.bias"] = tree["head"]["bias"]
    return to_tensors(sd)


def to_tensors(sd: Mapping) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def from_jax_fcmae(tree: Mapping, depths: Sequence[int], out_modalities: Sequence[str],
                   decoder_depth: int = 1) -> dict[str, torch.Tensor]:
    """JAX FCMAE params (numpy leaves) -> the port's (upstream's) state dict."""
    sd = from_jax_encoder(tree["encoder"], depths, prefix="encoder.")
    sd["proj.weight"] = _oihw(tree["proj"]["kernel"])
    sd["proj.bias"] = tree["proj"]["bias"]
    sd["mask_token"] = np.asarray(tree["mask_token"]).reshape(1, -1, 1, 1)
    for mod in out_modalities:
        for d in range(decoder_depth):
            _block(tree[f"decoder_{d}"], f"decoder_dict.{mod}.{d}", sd)
        head = tree[f"pred_{mod}"]
        sd[f"pred_dict.{mod}.weight"] = (_t(head["kernel"]) if mod in IMAGE_LEVEL
                                         else _oihw(head["kernel"]))
        sd[f"pred_dict.{mod}.bias"] = head["bias"]
    if "layer_norm_tmp" in tree:
        sd["layer_norm_tmp.weight"] = tree["layer_norm_tmp"]["scale"]
        sd["layer_norm_tmp.bias"] = tree["layer_norm_tmp"]["bias"]
    if "log_vars" in tree:
        sd["loss_fn.log_vars"] = tree["log_vars"]
    return to_tensors(sd)


def from_jax_unet(tree: Mapping, depths: Sequence[int],
                  use_orig_stem: bool = False) -> dict[str, torch.Tensor]:
    """JAX ConvNeXtV2Unet params -> state dict of the port's (upstream's)
    U-Net, the keys JAX ``flax_unet_to_torch(..., dims=dims)`` emits: the
    trunk, ``upsample_layers.{i}.{conv,norm}.*``,
    ``initial_conv_upsample.{0,1}.*``, the 1x1 ``head`` and upstream's
    unused final ``norm`` at its defaults (LN = 1/0)."""
    if use_orig_stem != ("stem_orig_conv" in tree):
        raise ValueError(f"use_orig_stem={use_orig_stem} but the tree's stem is "
                         f"{'the original' if 'stem_orig_conv' in tree else 'the dense'} one")
    sd = from_jax_encoder(tree, depths)
    for i in range(4):
        up = tree[f"upsample_layers_{i}"]
        sd[f"upsample_layers.{i}.conv.weight"] = _oihw(up["conv"]["kernel"])
        sd[f"upsample_layers.{i}.conv.bias"] = up["conv"]["bias"]
        sd[f"upsample_layers.{i}.norm.weight"] = up["norm"]["scale"]
        sd[f"upsample_layers.{i}.norm.bias"] = up["norm"]["bias"]
    sd["initial_conv_upsample.0.weight"] = _oihw(tree["initial_conv_upsample_conv"]["kernel"])
    sd["initial_conv_upsample.0.bias"] = tree["initial_conv_upsample_conv"]["bias"]
    sd["initial_conv_upsample.1.weight"] = tree["initial_conv_upsample_norm"]["scale"]
    sd["initial_conv_upsample.1.bias"] = tree["initial_conv_upsample_norm"]["bias"]
    sd["head.weight"] = _oihw(tree["head"]["kernel"])
    sd["head.bias"] = tree["head"]["bias"]
    last = np.shape(tree["downsample_convs_2"]["kernel"])[-1]
    sd["norm.weight"] = np.ones(last, np.float32)
    sd["norm.bias"] = np.zeros(last, np.float32)
    return to_tensors(sd)


def _bn(params: Mapping, stats: Mapping, prefix: str, sd: dict) -> None:
    sd[f"{prefix}.weight"] = params["scale"]
    sd[f"{prefix}.bias"] = params["bias"]
    sd[f"{prefix}.running_mean"] = stats["mean"]
    sd[f"{prefix}.running_var"] = stats["var"]
    sd[f"{prefix}.num_batches_tracked"] = None


def _resnet(params: Mapping, stats: Mapping, stage_sizes: Sequence[int], bottleneck: bool,
            prefix: str, sd: dict) -> None:
    sd[f"{prefix}conv1.weight"] = _oihw(params["stem_conv"]["kernel"])
    _bn(params["stem_norm"], stats["stem_norm"], f"{prefix}bn1", sd)
    for i, n_blocks in enumerate(stage_sizes):
        for j in range(n_blocks):
            p, s, key = params[f"stage{i}_{j}"], stats[f"stage{i}_{j}"], f"{prefix}layer{i + 1}.{j}"
            for c in range(3 if bottleneck else 2):
                sd[f"{key}.conv{c + 1}.weight"] = _oihw(p[f"Conv_{c}"]["kernel"])
                _bn(p[f"BatchNorm_{c}"], s[f"BatchNorm_{c}"], f"{key}.bn{c + 1}", sd)
            if "downsample_conv" in p:
                sd[f"{key}.downsample.0.weight"] = _oihw(p["downsample_conv"]["kernel"])
                _bn(p["downsample_norm"], s["downsample_norm"], f"{key}.downsample.1", sd)
    if "fc" in params:
        sd[f"{prefix}fc.weight"] = _t(params["fc"]["kernel"])
        sd[f"{prefix}fc.bias"] = params["fc"]["bias"]


def from_jax_resnet(params: Mapping, batch_stats: Mapping, stage_sizes: Sequence[int],
                    bottleneck: bool) -> dict[str, torch.Tensor]:
    """JAX ResNet or ResNetUnet params and ``batch_stats`` -> the port's
    torchvision-keyed state dict (the reverse of JAX ``torch_resnet_to_flax``,
    foreign.py:118-152); the U-Net's encoder under ``encoder.``, its decoder
    blocks as ``decoder.{k}.{conv,norm}{0,1}.*`` and its
    ``segmentation_head``.  ``num_batches_tracked``, which flax does not
    keep, is 0."""
    sd: dict = {}
    if "encoder" in params:
        _resnet(params["encoder"], batch_stats["encoder"], stage_sizes, bottleneck, "encoder.", sd)
        k = 0
        while f"decoder_{k}" in params:
            p, s = params[f"decoder_{k}"], batch_stats[f"decoder_{k}"]
            for c in range(2):
                sd[f"decoder.{k}.conv{c}.weight"] = _oihw(p[f"conv{c}"]["kernel"])
                _bn(p[f"norm{c}"], s[f"norm{c}"], f"decoder.{k}.norm{c}", sd)
            k += 1
        sd["segmentation_head.weight"] = _oihw(params["segmentation_head"]["kernel"])
        sd["segmentation_head.bias"] = params["segmentation_head"]["bias"]
    else:
        _resnet(params, batch_stats, stage_sizes, bottleneck, "", sd)
    return {k: torch.zeros((), dtype=torch.long) if v is None
            else torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def params_converter(model: torch.nn.Module, batch_stats: Mapping | None = None):
    """The function that turns a JAX param tree of ``model``'s kind (the
    FCMAE, the classifier, the U-Net or a ResNet, whose BatchNorm
    statistics come from ``batch_stats``: JAX's ``model_state
    ["batch_stats"]``) into the port's state dict."""
    from ..models.convnextv2 import ConvNeXtV2
    from ..models.fcmae import FCMAE
    from ..models.resnet import ResNet, ResNetUnet
    from ..models.unet import ConvNeXtV2Unet

    if isinstance(model, FCMAE):
        depth = len(model.decoder_dict[model.out_modalities[0]])
        return lambda t: from_jax_fcmae(t, model.encoder.depths, model.out_modalities, depth)
    if isinstance(model, ConvNeXtV2Unet):
        return lambda t: from_jax_unet(t, model.depths, "stem_orig_conv" in t)
    if isinstance(model, ConvNeXtV2):
        return lambda t: from_jax_classifier(t, model.depths)
    if isinstance(model, (ResNet, ResNetUnet)):
        if batch_stats is None:
            raise ValueError("a ResNet's params need its batch_stats")
        enc = model.encoder if isinstance(model, ResNetUnet) else model
        return lambda t: from_jax_resnet(t, batch_stats, enc.stage_sizes, enc.bottleneck)
    raise TypeError(f"no JAX param layout is known for {type(model).__name__}")


def _plain(tree):
    """``tree`` as :func:`orbax_io.load_tree` gives it: named tuples (optax's
    states) as dicts of their fields, those with none (its empty and masked
    nodes) as None, other tuples as lists."""
    if hasattr(tree, "_asdict"):
        fields = tree._asdict()
        return {k: _plain(v) for k, v in fields.items()} if fields else None
    if isinstance(tree, Mapping):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def tree_leaves(tree, path=()):
    """(path, leaf) of every leaf of a nested dict/list tree, None kept."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from tree_leaves(v, (*path, k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, (*path, i))
    else:
        yield path, tree


def _rebuild(tree, fn, path=()):
    if isinstance(tree, Mapping):
        return {k: _rebuild(v, fn, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, fn, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def name_paths(params: Mapping, to_port) -> dict[str, tuple]:
    """For each key of the port's state dict, the path of the JAX leaf it is
    made from: ``to_port`` run on a tree whose every leaf holds its own
    index plus a quarter (every layout change keeps a constant array
    constant, and no default the converter fills in, such as the U-Net's
    unused LayerNorm at 1 and 0, passes for one)."""
    paths = [p for p, _ in tree_leaves(params)]
    index = {p: i for i, p in enumerate(paths)}
    probe = _rebuild(params, lambda p, x: np.full(np.shape(x), index[p] + 0.25, np.float32))
    out = {}
    for name, t in to_port(probe).items():
        t = torch.as_tensor(t).reshape(-1)
        if not t.numel() or not bool((t == t[0]).all()):
            continue
        i = float(t[0]) - 0.25
        if i == int(i) and 0 <= i < len(paths):
            out[name] = paths[int(i)]
    return out


def _masked_merge(trees: list):
    """One tree from the trees of ``multi_transform``'s groups (NovoGrad's
    ``wd`` and ``nowd``), each holding a param's leaf where its group has
    the param and None (optax's masked node) elsewhere."""
    if len(trees) == 1:
        return trees[0]

    def pick(path, _):
        got = [_get(t, path) for t in trees]
        got = [g for g in got if g is not None]
        if len(got) > 1:
            raise ValueError(f"the leaf {path} is in {len(got)} optimizer groups")
        return got[0] if got else None

    return _rebuild(trees[0], pick)


def _find_states(node, slots: Sequence[str], found: dict, counts: list) -> None:
    """Collect each slot's trees (the optax states whose fields name them)
    and the update counts of a chain's states."""
    if isinstance(node, Mapping):
        if set(node) == {"count"}:  # the schedule's ScaleByScheduleState
            counts.insert(0, node["count"])
        elif "count" in node:
            counts.append(node["count"])
        for k, v in node.items():
            if k in slots:
                found.setdefault(k, []).append(v)
            elif k != "count":
                _find_states(v, slots, found, counts)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _find_states(v, slots, found, counts)


def from_jax_opt_state(opt_state: Mapping, optimizer, params: Mapping, to_port) -> dict:
    """A JAX optax state of ``make_pretrain_optimizer`` /
    ``make_finetune_optimizer`` (nested dicts and lists of numpy arrays, as
    :func:`orbax_io.load_tree` gives it) -> ``optimizer.state_dict()``'s
    layout (``train/optim.py::Optimizer``), for the port's optimizer of the
    same ``--opt`` family over the same trainable params.

    ``params`` is the JAX param tree the state belongs to and ``to_port``
    its converter (:func:`params_converter`); optax's own named tuples are
    taken too (:func:`_plain`).  The family's states are found
    by their fields, wherever the chain puts them (the clip, the probe's
    ``mask_updates``, the layer decay's ``scale_by_pytree`` move the
    indices): ``mu``/``nu`` (the Adam families, LAMB, NovoGrad, whose
    ``multi_transform`` groups are merged), ``trace`` (and RMSprop's ``nu``),
    ``e_g``/``e_x``, Adafactor's ``v_row``/``v_col``/``v``.  A slot the
    size of its param takes the param's layout change; NovoGrad's per-param
    norms are carried as they are; Adafactor's factored ``v_row`` and
    ``v_col`` drop the param's d0 and d1 (``optim.py::factored_dims``) and
    keep the other dims in the port's order.  ``count`` is the applied
    updates, ``mini_step`` and ``acc`` those of ``MultiSteps``."""
    from ..train.optim import SLOTS, flax_axes

    opt_state, params = _plain(opt_state), _plain(params)
    multi = "inner_opt_state" in opt_state
    inner = opt_state["inner_opt_state"] if multi else opt_state
    slots = SLOTS[optimizer.opt]
    found: dict[str, list] = {}
    counts: list = []
    _find_states(inner, slots, found, counts)
    paths = name_paths(params, to_port)
    missing = [n for n in optimizer.names if n not in paths]
    if missing:
        raise ValueError(f"no JAX leaf for the params {missing[:5]}")
    shapes = dict(tree_leaves(params))
    jax_shape = {n: np.shape(shapes[paths[n]]) for n in optimizer.names}

    def full(tree) -> dict[str, torch.Tensor]:
        """The slots the size of their param, in the port's layout."""
        filled = _rebuild(params, lambda p, x: (
            np.asarray(_get(tree, p), np.float32)
            if _get(tree, p) is not None and np.shape(_get(tree, p)) == np.shape(x)
            else np.zeros(np.shape(x), np.float32)))
        return to_port(filled)

    def whole(t: torch.Tensor, split) -> tuple:
        """The shape of the whole leaf of which ``t`` is this rank's shard
        where the slot is split over a model axis."""
        shape = list(t.shape)
        if split is not None:
            shape[split] *= optimizer.mesh.model
        return tuple(shape)

    state: dict = {"opt": optimizer.opt}
    for key in slots:
        if key not in found:
            raise ValueError(f"the optax state holds no {key!r} for --opt {optimizer.opt}")
        tree = _masked_merge(found[key])
        conv = full(tree)
        mine = {}
        for name, t, dims, split in zip(optimizer.names, optimizer.slots[key],
                                        optimizer.factored, optimizer.split[key]):
            shape = whole(t, split)
            leaf = _get(tree, paths[name])
            if leaf is None:
                raise ValueError(f"the optax state has no {key} for {name}")
            leaf = np.asarray(leaf, np.float32)
            # optax keeps a placeholder of shape (1,) where Adafactor does
            # not use a slot (v of a factored leaf, v_row and v_col of
            # another), and one norm a param for NovoGrad's nu
            placeholder = ((optimizer.opt == "adafactor" and (key == "v") == (dims is not None))
                           or (optimizer.opt == "novograd" and key == "nu"))
            if dims is not None and key in ("v_row", "v_col"):
                axes = flax_axes(t.dim() + 1)
                drop = axes.index(dims[1] if key == "v_row" else dims[0])
                kept = [axes[k] for k in range(len(axes)) if k != drop]
                value = torch.from_numpy(np.array(leaf.transpose(np.argsort(kept))))
            elif placeholder:
                value = torch.from_numpy(leaf.copy()).reshape(shape)
            elif leaf.shape == jax_shape[name]:
                value = conv[name].reshape(shape)
            else:
                raise ValueError(f"{key} of {name}: {leaf.shape} for a param of "
                                 f"{jax_shape[name]}")
            if tuple(value.shape) != shape:
                raise ValueError(f"{key} of {name}: {tuple(value.shape)}, the port holds "
                                 f"{shape}")
            mine[name] = value
        state[key] = mine
    if optimizer.acc is not None:
        if not multi:
            raise ValueError("the port accumulates (update_freq > 1), the optax state does not")
        conv = full(opt_state["acc_grads"])
        state["acc"] = {n: conv[n].reshape(whole(p, 0 if s else None)) for n, p, s
                        in zip(optimizer.names, optimizer.params, optimizer.shards)}
        state["mini_step"] = int(np.asarray(opt_state["mini_step"]))
    elif multi:
        raise ValueError("the optax state accumulates (MultiSteps), the port does not "
                         "(update_freq 1)")
    else:
        state["acc"], state["mini_step"] = None, 0
    if multi:
        state["count"] = int(np.asarray(opt_state["gradient_step"]))
    elif counts:
        state["count"] = int(np.asarray(counts[0]))
    else:
        raise ValueError("the optax state holds no update count")
    return state



# ---------------------------------------------------------------------------
# the other way: the port's state -> the JAX package's trees
# ---------------------------------------------------------------------------
class Fields(dict):
    """An optax state (a named tuple) in a tree written for JAX: its fields
    in their declared order, where a plain dict's keys are flattened in
    sorted order, as JAX flattens them."""


def _np(v) -> np.ndarray:
    """A numpy copy of ``v`` (bfloat16 as f32): a tree written later does
    not follow the live tensors."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy().copy()
    return np.array(v)


def flax_converter(model: torch.nn.Module):
    """The function that turns a state dict of ``model``'s kind (the FCMAE,
    the classifier, the U-Net, a ResNet or the ResNet-UNet) into the JAX
    param tree and its ``batch_stats`` (None for a model without
    BatchNorm): the inverse of :func:`params_converter`, through the copies
    of the JAX package's torch -> flax converters (:mod:`.to_flax`)."""
    from ..models.convnextv2 import ConvNeXtV2
    from ..models.fcmae import FCMAE
    from ..models.resnet import ResNet, ResNetUnet
    from ..models.unet import ConvNeXtV2Unet
    from . import to_flax

    def numpy_sd(sd):
        return {k: _np(v) for k, v in sd.items()}

    if isinstance(model, FCMAE):
        depth = len(model.decoder_dict[model.out_modalities[0]])
        return lambda sd: (to_flax.torch_fcmae_to_flax(
            numpy_sd(sd), model.encoder.depths, model.out_modalities, depth,
            "encoder.stem_orig.0.weight" in sd), None)
    if isinstance(model, ConvNeXtV2Unet):
        return lambda sd: (to_flax.torch_unet_to_flax(numpy_sd(sd), model.depths,
                                                      "stem_orig.0.weight" in sd), None)
    if isinstance(model, ConvNeXtV2):
        return lambda sd: (to_flax.torch_encoder_to_flax(numpy_sd(sd), model.depths,
                                                         "stem_orig.0.weight" in sd), None)
    if isinstance(model, ResNetUnet):
        enc = model.encoder
        return lambda sd: to_flax.torch_resnet_unet_to_flax(numpy_sd(sd), enc.stage_sizes,
                                                            enc.bottleneck)
    if isinstance(model, ResNet):
        return lambda sd: to_flax.torch_resnet_to_flax(numpy_sd(sd), model.stage_sizes,
                                                       model.bottleneck)
    raise TypeError(f"no JAX param layout is known for {type(model).__name__}")


def jax_step(state: Mapping, update_freq: int) -> int:
    """JAX's ``TrainState.step`` of an optimizer state: one a micro-step
    (``apply_gradients`` runs every micro-step, ``MultiSteps`` inside)."""
    return int(state["count"]) * max(update_freq, 1) + int(state["mini_step"])


def to_jax_opt_state(state: Mapping, optimizer, model: torch.nn.Module,
                     sd: Mapping | None = None):
    """``optimizer.state_dict()`` (``state``; whole leaves, as
    ``parallel/mesh.py::gather_state`` gives them on a grid) -> the optax
    state of the JAX chain of the same flags, the inverse of
    :func:`from_jax_opt_state`: :class:`Fields` for optax's named tuples,
    lists for its tuples, None for its empty and masked nodes, ``()`` for
    ``MultiSteps``' ``skip_state``, numpy leaves (f32 slots, int32 counts).

    The chain is ``make_pretrain_optimizer``'s for the FCMAE, else
    ``make_finetune_optimizer``'s (with its ``mask_updates``, which the JAX
    finetune driver always builds): the clip where ``optimizer.clip_grad``
    is set, the family's states (coupled L2 before the scaler, decoupled
    after it, LAMB's trust ratio, NovoGrad's ``multi_transform`` of its
    ``wd``/``nowd`` groups, RMSprop's inner chain), the schedule's count,
    ``scale_by_pytree`` under layer decay (``optimizer.scales``) and
    ``MultiSteps`` under ``update_freq`` > 1.  A slot the size of its param
    takes the param's layout change (``sd``, the model's whole state dict,
    gives the frozen params' shapes); Adafactor's factored ``v_row`` and
    ``v_col`` take back the param dim they drop; its ``(1,)`` placeholders
    and NovoGrad's per-param norms are carried as they are.  The params the
    optimizer does not train (a probe's frozen ones) hold zero slots and a
    zero accumulated gradient: JAX masks their updates whatever those hold."""
    from ..models.fcmae import FCMAE
    from ..train.optim import factored_dims, flax_axes

    sd = dict(model.state_dict() if sd is None else sd)
    masked = not isinstance(model, FCMAE)
    to_flax = flax_converter(model)
    params, stats = to_flax(sd)
    paths = name_paths(params, params_converter(model, stats))
    trained = set(optimizer.names)
    owner: dict = {}  # JAX leaf path -> the port's param (a trained name first)
    for name, _ in model.named_parameters(remove_duplicate=False):
        if name in paths and (paths[name] not in owner or name in trained):
            owner[paths[name]] = name
    index = {n: i for i, n in enumerate(optimizer.names)}
    count = np.asarray(int(state["count"]), np.int32)
    fam = optimizer.opt

    def factored(name):
        return (optimizer.factored[index[name]] if name in index
                else factored_dims(sd[name].shape) if fam == "adafactor" else None)

    def slot(key: str):
        """The JAX tree of slot ``key`` (or ``acc``, the accumulated
        gradient) over every param."""
        values = {n: _np(t) for n, t in state[key].items()}
        shaped = to_flax({k: values[k] if k in values and values[k].shape == tuple(v.shape)
                          else np.zeros(tuple(v.shape), np.float32) for k, v in sd.items()})[0]

        def leaf(path, x):
            name = owner.get(path)
            if name is None:
                raise ValueError(f"no param of the port for the JAX leaf {path}")
            dims = factored(name) if key in ("v_row", "v_col", "v") else None
            if fam == "novograd" and key == "nu":
                return values[name].reshape(()) if name in values else np.zeros((), np.float32)
            if dims is not None and key in ("v_row", "v_col"):
                # the JAX leaf's axes are the param's flax axes but the one dropped
                drop = dims[1] if key == "v_row" else dims[0]
                kept = [a for a in flax_axes(len(sd[name].shape)) if a != drop]
                if name not in values:
                    return np.zeros([sd[name].shape[a] for a in kept], np.float32)
                return np.ascontiguousarray(values[name].transpose(np.argsort(np.argsort(kept))))
            if key in ("v_row", "v_col", "v") and (key == "v") == (dims is not None):
                return values[name].copy() if name in values else np.zeros(1, np.float32)
            return np.asarray(x, np.float32)

        return _rebuild(shaped, leaf)

    def group(tree, decayed: bool):
        """NovoGrad's group: the leaves of the params it holds, None elsewhere."""
        def keep(path, x):
            name = owner[path]
            wd = name in index and optimizer.decay[index[name]]
            return x if wd == decayed else None
        return _rebuild(tree, keep)

    adam = lambda: Fields(count=count, mu=slot("mu"), nu=slot("nu"))  # noqa: E731
    wd = Fields(inner_state=None)  # add_decayed_weights(mask=...)'s MaskedState
    chain: list = []
    if masked:
        chain.append(None)  # mask_updates
    if optimizer.clip_grad is not None:
        chain.append(None)  # clip_by_global_norm
    if not masked and fam != "adamw":
        raise ValueError(f"the pretraining chain is AdamW's, not {fam}'s")
    if fam == "adamw":
        chain += [adam(), wd]
    elif fam == "lamb":
        chain += [adam(), wd, None]  # scale_by_trust_ratio
    elif fam == "novograd":
        mu, nu = slot("mu"), slot("nu")
        chain.append(Fields(inner_states={
            g: Fields(inner_state=Fields(count=count, mu=group(mu, g == "wd"),
                                         nu=group(nu, g == "wd")))
            for g in ("wd", "nowd")}))
    else:
        scaler = {"sgd": lambda: Fields(trace=slot("trace")),
                  "momentum": lambda: Fields(trace=slot("trace")),
                  "adadelta": lambda: Fields(e_g=slot("e_g"), e_x=slot("e_x")),
                  "adafactor": lambda: Fields(count=count, v_row=slot("v_row"),
                                              v_col=slot("v_col"), v=slot("v")),
                  "rmsprop": lambda: [Fields(nu=slot("nu")), Fields(trace=slot("trace"))]}
        chain += [wd, scaler.get(fam, adam)()]
    chain.append(Fields(count=count))  # the schedule's ScaleByScheduleState
    if optimizer.scales is not None:
        chain.append(None)  # scale_by_pytree (layer decay)
    if optimizer.update_freq <= 1:
        return chain
    return Fields(mini_step=np.asarray(int(state["mini_step"]), np.int32), gradient_step=count,
                  inner_opt_state=chain, acc_grads=slot("acc"), skip_state=())

"""The port's ArrayRecord packs and ``--loader grain`` against the JAX
package on the CPU: packs written by either package decode equal and each
reads the other's, unshuffled batches equal JAX ``GrainLoader``'s record for
record, shuffled epochs cover each record once, shards partition them,
``set_epoch`` reshuffles, a stream resumed from ``get_state`` (mid-epoch and
across an epoch boundary) continues as the unbroken stream does,
``main_pretrain --loader grain`` resumed from its ``.pth`` mid-stream gives
the unbroken run's losses, and the path never imports JAX."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("array_record")
h5py = pytest.importorskip("h5py")

from mmearth_tpu.configs import modalities as JM  # noqa: E402
from mmearth_tpu.data import grain_pipeline as jgp  # noqa: E402
from mmearth_tpu.data import mmearth as jmm  # noqa: E402
from mmearth_tpu_torch import main_pretrain  # noqa: E402
from mmearth_tpu_torch.configs import modalities as M  # noqa: E402
from mmearth_tpu_torch.data import grain_pipeline as gp  # noqa: E402
from mmearth_tpu_torch.data import mmearth as mm  # noqa: E402
from mmearth_tpu_torch.data.synthetic import generate  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, TILE = 40, 16
MODS = M.modality_preset("default")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """The train split (35 records) of one HDF5 dataset packed by JAX's and
    by the port's packer, shards of 16 records."""
    root = tmp_path_factory.mktemp("arpacks")
    generate(root / "h5", n=N, tile=TILE, seed=3)
    jgp.pack_arrayrecord(jmm.MMEarthDataset(root / "h5", JM.modality_preset("default")),
                         root / "jax", shard_size=16)
    gp.pack_arrayrecord(mm.MMEarthDataset(root / "h5", MODS), root / "ours", shard_size=16)
    return root


def _records(path):
    from array_record.python.array_record_module import ArrayRecordReader

    meta = json.loads((path / "meta.json").read_text())
    out = []
    for s in meta["shards"]:
        r = ArrayRecordReader(str(path / s))
        out.extend(gp._decode_sample(x) for x in r.read_all())
        r.close()
    return meta, out


def test_packs_decode_equal_whichever_package_wrote_them(packs):
    (m_j, r_j), (m_o, r_o) = _records(packs / "jax"), _records(packs / "ours")
    assert m_j == m_o and m_o["count"] == 35 and len(m_o["shards"]) == 3
    assert len(r_j) == len(r_o) == 35
    for a, b in zip(r_j, r_o):
        assert set(a) == set(b) == set(MODS)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    assert jgp._decode_sample(gp._encode_sample(r_o[0])).keys() == r_o[0].keys()


@pytest.mark.parametrize("writer", ["jax", "ours"])
@pytest.mark.parametrize("batch,drop_last,shard", [(8, True, (0, 1)), (8, False, (0, 1)),
                                                   (4, False, (1, 2)), (3, True, (0, 3))])
def test_unshuffled_batches_equal_jax_grainloaders(packs, writer, batch, drop_last, shard):
    kw = dict(batch_size=batch, shuffle=False, drop_last=drop_last, seed=0, shard=shard)
    ours, ref = gp.GrainLoader(packs / writer, **kw), jgp.GrainLoader(packs / writer, **kw)
    got, want = list(ours), list(ref)
    assert len(got) == len(want) == len(ours) == len(ref)
    for a, b in zip(got, want):
        for k in b:
            assert a[k].tobytes() == b[k].tobytes(), k
    # the stream's first epoch too
    it, rit = ours.iterator(), ref.iterator()
    for _ in range(len(ours) + 1):
        assert next(it)["lat"].tobytes() == next(rit)["lat"].tobytes()


def _ids(batches):
    return [tuple(r) for b in batches for r in b["lat"].tolist()]


def test_shuffled_epochs_cover_each_record_once_and_shards_partition(packs):
    full = gp.GrainLoader(packs / "ours", batch_size=5, shuffle=False, drop_last=False)
    every = sorted(_ids(full))
    loader = gp.GrainLoader(packs / "ours", batch_size=5, seed=4, drop_last=False)
    epochs = []
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        epochs.append(_ids(loader))
        assert sorted(epochs[-1]) == every
    assert epochs[0] != epochs[1]  # set_epoch reshuffles
    loader.set_epoch(0)
    assert _ids(loader) == epochs[0]  # and the same epoch draws the same order
    parts = []
    for rank in range(2):
        shard = gp.GrainLoader(packs / "ours", batch_size=4, seed=4, shard=(rank, 2),
                               drop_last=False)
        shard.set_epoch(1)
        parts.append(_ids(shard))
    assert not set(parts[0]) & set(parts[1]) and sorted(parts[0] + parts[1]) == every
    dropped = gp.GrainLoader(packs / "ours", batch_size=4, seed=4, shard=(1, 2))
    assert len(dropped) == 17 // 4 and all(len(b["lat"]) == 4 for b in dropped)


@pytest.mark.parametrize("drop_last", [True, False])
def test_stream_resumes_mid_epoch_and_across_a_boundary(packs, drop_last):
    """35 records at batch 8: the stream drops (or emits) each epoch's tail
    of 3; a loader set to the state after any batch continues exactly as
    the unbroken stream does."""
    make = lambda: gp.GrainLoader(packs / "ours", batch_size=8, seed=9, drop_last=drop_last)
    unbroken, states = make(), []
    it = unbroken.iterator()
    stream = []
    for _ in range(12):
        stream.append(_ids([next(it)]))
        states.append(unbroken.get_state())
    per_epoch = 4 if drop_last else 5
    for e in range(2):
        epoch = [r for b in stream[e * per_epoch:(e + 1) * per_epoch] for r in b]
        assert len(set(epoch)) == len(epoch) == (32 if drop_last else 35)
    for at in (1, per_epoch - 1, per_epoch, per_epoch + 2):
        fresh = make()
        fresh.set_state(states[at - 1])
        rit = fresh.iterator()
        assert [_ids([next(rit)]) for _ in range(12 - at)] == stream[at:]
    with pytest.raises(ValueError, match="seed"):
        gp.GrainLoader(packs / "ours", batch_size=8, seed=10).set_state(states[0])


def _args(data_dir, out, epochs, *extra):
    return main_pretrain.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--batch_size", "4", "--device", "cpu", "--data_dir", str(data_dir),
        "--processed_dir", str(out), "--epochs", str(epochs), "--warmup_epochs", "1",
        "--use_bf16", "False", "--decoder_embed_dim", "64", "--loader", "grain",
        "--output_dir", str(out / "ckpt"), "--save_ckpt_num", "3", *extra])


def test_main_pretrain_loader_grain_resumes_mid_stream(tmp_path):
    """14 samples (13 train) at batch 4: 3 steps an epoch, one record of each
    shuffle epoch dropped.  Two epochs in one run equal one epoch, then a
    run resumed from its ``.pth`` (the stream's position restored)."""
    generate(tmp_path / "h5", n=14, tile=64, seed=1)
    _, whole, _ = main_pretrain.main(_args(tmp_path / "h5", tmp_path / "a", 2))
    assert (tmp_path / "a" / "train_arrayrecord" / "meta.json").exists()
    _, first, _ = main_pretrain.main(_args(tmp_path / "h5", tmp_path / "b", 1))
    _, rest, _ = main_pretrain.main(_args(tmp_path / "h5", tmp_path / "b", 2))
    assert [e["epoch"] for e in rest] == [1] and [e["steps"] for e in whole] == [3, 3]
    np.testing.assert_array_equal([x for e in first + rest for x in e["step_losses"]],
                                  [x for e in whole for x in e["step_losses"]])


_NO_JAX = """
import sys
from mmearth_tpu_torch import main_pretrain
args = main_pretrain.get_args_parser().parse_args(sys.argv[1:])
_, history, _ = main_pretrain.main(args)
print("steps", history[0]["steps"])
print("jax loaded:", "jax" in sys.modules, "grain loaded:", "grain" in sys.modules,
      "mmearth_tpu loaded:", "mmearth_tpu" in sys.modules)
"""


def test_loader_grain_path_never_imports_jax(packs, tmp_path):
    """``--debug`` packs a 10-record subset from the HDF5 and trains on it,
    all in a process that never loads jax, grain or the JAX package."""
    argv = ["--model", "convnextv2_atto", "--input_size", "16", "--patch_size", "8",
            "--batch_size", "4", "--device", "cpu", "--data_dir", str(packs / "h5"),
            "--processed_dir", str(tmp_path), "--epochs", "1", "--warmup_epochs", "1",
            "--use_bf16", "False", "--decoder_embed_dim", "16", "--loader", "grain",
            "--debug", "True"]
    r = subprocess.run([sys.executable, "-c", _NO_JAX, *argv], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "steps 2" in r.stdout
    assert "jax loaded: False grain loaded: False mmearth_tpu loaded: False" in r.stdout
    assert (tmp_path / "train_arrayrecord_subset" / "meta.json").exists()

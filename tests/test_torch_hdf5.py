"""The port's MMEarth HDF5 reader, packer and ``--loader hdf5`` against the
JAX package on the CPU: ``generate`` writes the same file, ``get_rows`` and
``pack_mmearth`` are bit- and byte-identical, the HDF5 pack equals
``generate_packed``'s, ``HDF5StreamLoader`` yields JAX's batches (and covers
an epoch exactly, propagates a read error, reclaims an abandoned worker),
``main_pretrain --loader hdf5`` trains, and without ``h5py`` the port imports
and the HDF5 paths refuse, naming it."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from mmearth_tpu.configs import modalities as JM  # noqa: E402
from mmearth_tpu.data import mmearth as jmm  # noqa: E402
from mmearth_tpu.data import pack as jpack  # noqa: E402
from mmearth_tpu.data.synthetic import generate as jax_generate  # noqa: E402
from mmearth_tpu_torch import main_pretrain  # noqa: E402
from mmearth_tpu_torch.configs import modalities as M  # noqa: E402
from mmearth_tpu_torch.data import mmearth as mm  # noqa: E402
from mmearth_tpu_torch.data import pack  # noqa: E402
from mmearth_tpu_torch.data.synthetic import generate, generate_packed  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, TILE, SEED = 24, 16, 2
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
def dirs(tmp_path_factory):
    """The same synthetic dataset written by JAX's and the port's generator."""
    root = tmp_path_factory.mktemp("h5")
    jax_generate(root / "jax", n=N, tile=TILE, seed=SEED)
    generate(root / "ours", n=N, tile=TILE, seed=SEED)
    return root


def test_generate_writes_jaxs_file(dirs):
    ref, ours = dirs / "jax", dirs / "ours"
    assert sorted(p.name for p in ours.iterdir()) == sorted(p.name for p in ref.iterdir())
    for p in ref.glob("*.json"):
        assert json.loads((ours / p.name).read_text()) == json.loads(p.read_text()), p.name
    with h5py.File(ref / "data_synth.h5") as a, h5py.File(ours / "data_synth.h5") as b:
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k][()].tobytes() == b[k][()].tobytes(), k


@pytest.mark.parametrize("split", ["train", "val"])
def test_get_rows_bit_identical_to_jax(dirs, split):
    """Every modality, duplicate positions, l1c and l2a tiles (odd and even
    rows), in an unsorted order."""
    ours = mm.MMEarthDataset(dirs / "ours", MODS, split=split)
    ref = jmm.MMEarthDataset(dirs / "ours", JM.modality_preset("default"), split=split)
    pos = np.array([2, 0, 2, 1, len(ours) - 1, 1]) % len(ours)
    got, want = ours.get_rows(pos), ref.get_rows(pos)
    assert got["id"] == want["id"] and len(set(got["id"])) < len(pos)
    tiles = {ours.tile_info[i]["S2_type"] for i in got["id"]}
    assert tiles == {"l1c", "l2a"} or split == "val"
    assert set(got) == set(want) == {*MODS, "id"}
    for k in MODS:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
    item = ours[int(pos[0])]
    assert item["id"] == got["id"][0] and item["sentinel2"].tobytes() == got["sentinel2"][0].tobytes()


def test_pack_mmearth_byte_identical_to_jax_and_to_generate_packed(dirs, tmp_path):
    splits = ("train", "val")
    jpack.pack_mmearth(dirs / "ours", tmp_path / "jax", JM.modality_preset("default"),
                       splits=splits)
    out = pack.pack_mmearth(dirs / "ours", tmp_path / "ours", MODS, splits=splits)
    assert out == [tmp_path / "ours" / s for s in splits]
    generate_packed(tmp_path / "direct", n=N, tile=TILE, seed=SEED)
    for split in splits:
        ref = tmp_path / "jax" / split
        for other in (tmp_path / "ours" / split, tmp_path / "direct" / split):
            assert sorted(p.name for p in other.iterdir()) == sorted(p.name for p in ref.iterdir())
            for p in ref.glob("*.bin"):
                assert (other / p.name).read_bytes() == p.read_bytes(), (other, p.name)
            for name in ("meta.json", "ids.json"):
                assert json.loads((other / name).read_text()) == json.loads(
                    (ref / name).read_text()), (other, name)
    # packed already: nothing is rewritten
    stamp = (tmp_path / "ours" / "train" / "meta.json").stat().st_mtime_ns
    pack.pack_mmearth(dirs / "ours", tmp_path / "ours", MODS, splits=("train",))
    assert (tmp_path / "ours" / "train" / "meta.json").stat().st_mtime_ns == stamp


def test_pack_cli_and_a_subset(dirs, tmp_path):
    pack.main(["--data_dir", str(dirs / "ours"), "--out", str(tmp_path / "cli"),
               "--splits", "val", "--modalities", "rgb"])
    meta = json.loads((tmp_path / "cli" / "val" / "meta.json").read_text())
    assert meta["count"] == N // 8 and meta["fields"] == {
        "sentinel2": {"shape": [TILE, TILE, 3], "dtype": "float32"}}
    sub = pack.pack_mmearth(dirs / "ours", tmp_path / "sub", MODS, indices=[[4, 1]])[0]
    assert sub.name == "train_subset"
    assert json.loads((sub / "ids.json").read_text()) == ["tile_000004", "tile_000001"]


@pytest.mark.parametrize("shuffle,shard,drop_last", [(True, (0, 1), True),
                                                     (True, (1, 2), False),
                                                     (False, (0, 1), False)])
def test_stream_loader_batches_equal_jaxs(dirs, shuffle, shard, drop_last):
    ours = mm.HDF5StreamLoader(mm.MMEarthDataset(dirs / "ours", MODS), batch_size=4,
                               shuffle=shuffle, drop_last=drop_last, seed=3, shard=shard)
    ref = jmm.HDF5StreamLoader(jmm.MMEarthDataset(dirs / "ours", JM.modality_preset("default")),
                               batch_size=4, shuffle=shuffle, drop_last=drop_last, seed=3,
                               shard=shard)
    for epoch in (0, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours) > 0
        for a, b in zip(got, want):
            assert set(a) == set(MODS)
            for k in b:
                assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


def test_stream_loader_covers_an_epoch_exactly(dirs):
    ds = mm.MMEarthDataset(dirs / "ours", MODS)
    seen = []
    for rank in range(2):
        loader = mm.HDF5StreamLoader(ds, batch_size=3, seed=1, shard=(rank, 2), drop_last=False)
        loader.set_epoch(4)
        for b in loader:
            assert b["dynamic_world"].dtype == np.int32
            seen.extend(map(tuple, b["lat"].tolist()))
    ref = ds.get_rows(np.arange(len(ds)))["lat"]
    assert sorted(seen) == sorted(map(tuple, ref.tolist()))


def test_stream_loader_read_error_propagates(dirs):
    ds = mm.MMEarthDataset(dirs / "ours", MODS)

    class Boom(mm.MMEarthDataset):
        def __init__(self):
            self.__dict__.update(ds.__dict__)

        def get_rows(self, positions):
            if np.asarray(positions).max() >= 8:
                raise RuntimeError("corrupt chunk")
            return super().get_rows(positions)

    with pytest.raises(RuntimeError, match="corrupt chunk"):
        for _ in mm.HDF5StreamLoader(Boom(), batch_size=4, shuffle=False, prefetch=2):
            pass


def test_stream_loader_abandoned_iterator_reclaims_its_thread(dirs):
    import gc
    import threading
    import time

    loader = mm.HDF5StreamLoader(mm.MMEarthDataset(dirs / "ours", MODS), batch_size=2,
                                 shuffle=False, prefetch=1)
    base = threading.active_count()
    next(iter(loader))
    gc.collect()
    deadline = time.time() + 8
    while threading.active_count() > base and time.time() < deadline:
        time.sleep(0.1)
    assert threading.active_count() <= base


def _pretrain_args(data_dir, out, *extra):
    return main_pretrain.get_args_parser().parse_args([
        "--model", "convnextv2_atto", "--input_size", "56", "--patch_size", "8",
        "--batch_size", "4", "--device", "cpu", "--data_dir", str(data_dir),
        "--processed_dir", str(out), "--epochs", "1", "--warmup_epochs", "1",
        "--use_bf16", "False", "--decoder_embed_dim", "64", "--loader", "hdf5", *extra])


def test_main_pretrain_loader_hdf5_takes_two_steps_on_cpu(tmp_path):
    """12 samples (11 train) at batch 4: two steps straight from the HDF5,
    nothing packed; the same two batches, the same losses as training on
    the split packed from it."""
    generate(tmp_path / "h5", n=12, tile=64, seed=0)
    _, history, _ = main_pretrain.main(_pretrain_args(tmp_path / "h5", tmp_path / "proc"))
    assert history[0]["steps"] == 2 and all(np.isfinite(history[0]["step_losses"]))
    assert not (tmp_path / "proc").exists()
    args = _pretrain_args(tmp_path / "h5", tmp_path / "proc")
    args.loader = "mmpack"
    _, packed, _ = main_pretrain.main(args)
    assert (tmp_path / "proc" / "train" / "meta.json").exists()
    np.testing.assert_allclose(packed[0]["step_losses"], history[0]["step_losses"],
                               rtol=1e-6)


_NO_H5PY = """
import sys
sys.modules["h5py"] = None
import mmearth_tpu_torch.data.synthetic, mmearth_tpu_torch.data.pack
import mmearth_tpu_torch.data.mmearth, mmearth_tpu_torch.train.pretrain
from mmearth_tpu_torch import main_pretrain
args = main_pretrain.get_args_parser().parse_args(
    ["--device", "cpu", "--loader", "hdf5", "--data_dir", sys.argv[1]])
try:
    main_pretrain.main(args)
except ImportError as e:
    print("refused:", e)
"""


def test_without_h5py_the_port_imports_and_hdf5_refuses(dirs):
    r = subprocess.run([sys.executable, "-c", _NO_H5PY, str(dirs / "ours")], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "refused:" in r.stdout and "h5py" in r.stdout

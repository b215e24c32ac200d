"""The port's synthetic mmpack writer and loader against the JAX package:
``generate_packed`` is byte-identical to ``mmearth_tpu.data.synthetic.generate``
+ ``pack_mmearth`` (HDF5 in between), and the port's PackedLoader yields the
JAX loader's batches."""
import json

import numpy as np
import pytest

from mmearth_tpu.configs import modalities as JM
from mmearth_tpu.data.loader import PackedDataset as JaxPackedDataset
from mmearth_tpu.data.loader import PackedLoader as JaxPackedLoader
from mmearth_tpu.data.pack import pack_mmearth
from mmearth_tpu.data.synthetic import generate
from mmearth_tpu_torch.data.loader import PackedDataset, PackedLoader
from mmearth_tpu_torch.data.synthetic import generate_packed, synthetic_batch

N, TILE, SEED = 20, 16, 4


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    root = tmp_path_factory.mktemp("packs")
    generate(root / "h5", n=N, tile=TILE, seed=SEED)
    pack_mmearth(root / "h5", root / "ref", JM.modality_preset("default"),
                 splits=("train", "val"))
    generate_packed(root / "ours", n=N, tile=TILE, seed=SEED)
    return root / "ref", root / "ours"


@pytest.mark.parametrize("split", ["train", "val"])
def test_generate_packed_is_byte_identical(packs, split):
    ref, ours = packs[0] / split, packs[1] / split
    assert sorted(p.name for p in ours.iterdir()) == sorted(p.name for p in ref.iterdir())
    for p in ref.iterdir():
        assert (ours / p.name).read_bytes() == p.read_bytes(), p.name
    meta = json.loads((ours / "meta.json").read_text())
    assert meta["count"] == (N - N // 8 if split == "train" else N // 8)
    assert meta["fields"]["dynamic_world"]["dtype"] == "int32"


def test_synthetic_batch_is_the_packed_rows(packs):
    ds = PackedDataset(packs[1] / "train")
    batch = synthetic_batch(N, TILE, seed=SEED)
    for k, v in batch.items():
        np.testing.assert_array_equal(v[:len(ds)], ds.arrays[k], err_msg=k)


@pytest.mark.parametrize("order", ["random", "quasi_random", "sequential"])
def test_loader_yields_the_jax_loaders_batches(packs, order):
    ours = PackedLoader(PackedDataset(packs[1] / "train"), batch_size=4, seed=3, order=order,
                        chunk_size=2, window_chunks=2)
    ref = JaxPackedLoader(JaxPackedDataset(packs[0] / "train"), batch_size=4, seed=3,
                          order=order, chunk_size=2, window_chunks=2)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == (N - N // 8) // 4
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)

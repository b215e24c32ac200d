"""The port's native row gather (``mmearth_tpu_torch/data/native``): its g++
build, bit-exact against ``np.take`` (its plain version) across dtypes and
thread counts, the bounds check on both gathers, builds racing in two
processes, a broken compiler raising, and the loader on it against JAX's
``PackedLoader`` with shards and prefetch off."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from mmearth_tpu.data.loader import PackedDataset as JaxPackedDataset
from mmearth_tpu.data.loader import PackedLoader as JaxPackedLoader
from mmearth_tpu_torch.data import native
from mmearth_tpu_torch.data.loader import PackedDataset, PackedLoader
from mmearth_tpu_torch.data.synthetic import generate_packed

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def memmaps(tmp_path_factory):
    """float32, int32 and uint8 fields as .npy memmaps of 300 rows."""
    d = tmp_path_factory.mktemp("fields")
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.normal(size=(300, 7, 5, 3)).astype(np.float32),
              "i32": rng.integers(-5, 9, size=(300, 11)).astype(np.int32),
              "u8": rng.integers(0, 256, size=(300, 846)).astype(np.uint8)}
    out = {}
    for name, a in arrays.items():
        mm = np.lib.format.open_memmap(d / f"{name}.bin", mode="w+", dtype=a.dtype,
                                       shape=a.shape)
        mm[:] = a
        mm.flush()
        out[name] = np.lib.format.open_memmap(d / f"{name}.bin", mode="r")
    return out


@pytest.mark.parametrize("n_threads", [1, 2, 4, 0])
@pytest.mark.parametrize("field", ["f32", "i32", "u8"])
def test_gather_is_bit_exact_to_np_take(memmaps, field, n_threads, monkeypatch):
    """Every thread count really used: the floor of bytes a thread and the
    cap of half the cores are lifted for these small fields."""
    monkeypatch.setattr(native, "MIN_BYTES_PER_THREAD", 1)
    monkeypatch.setattr(native.os, "cpu_count", lambda: 16)
    src = memmaps[field]
    rows = np.random.default_rng(n_threads).integers(0, len(src), size=97)
    rows[:3] = (0, len(src) - 1, rows[5])  # the ends and a repeat
    want = np.take(np.asarray(src), rows, axis=0)
    got = native.gather_rows(src, rows, n_threads=n_threads)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    out = np.full_like(want, 7)
    assert native.gather_rows(src, rows, out=out, n_threads=n_threads) is out
    assert out.tobytes() == want.tobytes()
    assert native.take_rows(src, rows).tobytes() == want.tobytes()
    native.prefetch_rows(src, rows)  # a hint: returns, changes nothing
    assert native.gather_rows(src, rows[:0]).shape == (0, *src.shape[1:])


def test_threads_for_caps_by_request_cores_and_bytes(monkeypatch):
    monkeypatch.setattr(native.os, "cpu_count", lambda: 8)
    mb = native.MIN_BYTES_PER_THREAD
    assert native.threads_for(mb - 1, 10) == 1  # a small copy: one thread
    assert native.threads_for(3 * mb, 10) == 3
    assert native.threads_for(50 * mb, 10) == 4  # never past half the cores
    assert native.threads_for(50 * mb, 2) == 2 and native.threads_for(50 * mb, 0) == 4
    assert native.threads_for(0, 0) == 1
    monkeypatch.setattr(native.os, "cpu_count", lambda: 1)
    assert native.threads_for(50 * mb, 10) == 1


@pytest.mark.parametrize("gather", [native.gather_rows, native.take_rows])
@pytest.mark.parametrize("bad", [300, -1, 10 ** 9])
def test_out_of_range_rows_raise(memmaps, gather, bad):
    """Both gathers refuse a row outside [0, len(src)) before copying, where
    ``np.take(mode="clip")`` read the last row."""
    src = memmaps["i32"]
    out = np.zeros((3, *src.shape[1:]), src.dtype)
    with pytest.raises(IndexError, match=str(bad)):
        gather(src, np.array([1, bad, 2]), out=out)
    assert not out.any()


def test_packed_dataset_gather_raises_out_of_range(tmp_path):
    generate_packed(tmp_path, n=16, tile=8, seed=0, splits=("train",))
    ds = PackedDataset(tmp_path / "train")
    np.testing.assert_array_equal(ds.gather(np.array([0, 3]))["lat"], ds.arrays["lat"][[0, 3]])
    with pytest.raises(IndexError):
        ds.gather(np.array([0, ds.count]))


def test_mismatched_layouts_raise(memmaps):
    src = memmaps["f32"]
    with pytest.raises(ValueError, match="out is"):
        native.gather_rows(src, [0, 1], out=np.zeros((2, 7, 5, 3), np.float64))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_rows(src, [0, 1], out=np.zeros((2, 3, 5, 7), np.float32).transpose(0, 3, 2, 1))


_RACE = """
import sys
from pathlib import Path
import numpy as np
from mmearth_tpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
src = np.arange(40, dtype=np.int64).reshape(10, 4)
assert (native.gather_rows(src, [9, 0, 3]) == src[[9, 0, 3]]).all()
print(native.build())
"""


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    built = sorted(tmp_path.iterdir())
    assert [p.name for p in built] == [Path(outs[0][0].strip()).name]
    assert outs[0][0] == outs[1][0]


def test_a_broken_compiler_raises(tmp_path, monkeypatch):
    """No fallback: with the compiler missing, the first gather raises and
    names it; with one that fails, the error carries its exit."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "fresh")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    src = np.zeros((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="no-such-g"):
        native.gather_rows(src, [1])
    monkeypatch.setattr(native, "CXX", "false")
    with pytest.raises(RuntimeError, match="false failed"):
        native.build()
    assert not any((tmp_path / "fresh").iterdir())


def test_loader_on_native_gather_matches_jax_with_shards(tmp_path):
    """Shards (0, 2) and (1, 2), 1 and 3 gather threads, prefetch on and
    off: the JAX loader's batches (the same pack under both)."""
    generate_packed(tmp_path, n=40, tile=8, seed=1, splits=("train",))
    for shard in ((0, 2), (1, 2)):
        for workers, prefetch in ((1, 0), (3, 2)):
            ours = PackedLoader(PackedDataset(tmp_path / "train"), batch_size=4, seed=5,
                                shard=shard, num_workers=workers, prefetch=prefetch)
            ref = JaxPackedLoader(JaxPackedDataset(tmp_path / "train"), batch_size=4, seed=5,
                                  shard=shard, num_workers=workers, prefetch=prefetch)
            for epoch in (0, 1):
                ours.set_epoch(epoch)
                ref.set_epoch(epoch)
                got, want = list(ours), list(ref)
                assert len(got) == len(want) == 35 // 2 // 4
                for a, b in zip(got, want):
                    for k in b:
                        assert a[k].tobytes() == b[k].tobytes(), k


def test_readahead_hint_only_for_a_pack_past_the_page_cache(tmp_path, monkeypatch):
    """A pack within half the host's memory is read without the hint; one
    past it hints every batch but the first, one batch ahead."""
    from mmearth_tpu_torch.data import loader as loader_mod

    generate_packed(tmp_path, n=24, tile=8, seed=0, splits=("train",))
    assert not PackedDataset(tmp_path / "train").readahead
    monkeypatch.setattr(loader_mod, "host_memory_bytes", lambda: 1000)
    ds = PackedDataset(tmp_path / "train")
    assert ds.readahead
    hinted = []
    monkeypatch.setattr(ds, "prefetch", lambda rows: hinted.append(rows.tolist()))
    loader = PackedLoader(ds, batch_size=5, seed=2)
    batches = loader._epoch_batches()
    got = list(loader)
    assert len(got) == len(batches) == 4
    assert hinted == [sorted(b.tolist()) for b in batches[1:]]
    ds.readahead = False
    hinted.clear()
    assert len(list(loader)) == 4 and hinted == []

"""The port's ``make_grain_loader`` (PyTorch's DataLoader) against the JAX
package's grain loader: the same batches in order without shuffling (two
epochs, a short batch running across the epoch's end as grain's does),
coverage of every index once an epoch with shuffling, batches equal to
``get_batch_raw`` of their indices, worker processes, and a source that
pickles paths, not arrays. The shuffled order is the port's own
(ROADMAP §C), so only its coverage is compared.

Tolerance: none; the loaders copy raw float32 samples."""

import pickle

import numpy as np
import pytest

from unet_convlstm_tpu.data.npz_dataset import NPZSequenceDataset as JDS
from unet_convlstm_tpu.data.pipeline import make_grain_loader as jax_loader
from unet_convlstm_tpu_torch.data.npz_dataset import NPZSequenceDataset as TDS
from unet_convlstm_tpu_torch.data.pipeline import (_LoaderSource,
                                                  make_grain_loader)

N, T, HW = 11, 2, 8


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """X[i] carries its sample index i in every pixel of channel 0."""
    rng = np.random.default_rng(0)
    X = rng.random((N, T, 2, HW, HW)).astype(np.float32)
    X[:, :, 0] = np.arange(N, dtype=np.float32)[:, None, None, None]
    Y = rng.standard_normal((N, T, 1, HW, HW)).astype(np.float32)
    path = str(tmp_path_factory.mktemp("grain") / "d.npz")
    np.savez(path, X=X, Y=Y)
    return path


def _ids(x):
    return [int(v) for v in x[:, 0, 0, 0, 0]]


def test_unshuffled_batches_equal_jax_grain_loader(npz):
    idx = np.array([7, 1, 3, 9, 0, 4, 2, 10])
    want = list(jax_loader(JDS(npz), idx, 3, shuffle=False, num_epochs=2))
    got = list(make_grain_loader(TDS(npz), idx, 3, shuffle=False,
                                 num_epochs=2))
    assert [x.shape[0] for x, _ in got] == [3, 3, 3, 3, 3, 1]
    assert len(got) == len(want)
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)


def test_shuffled_epochs_cover_every_index_once(npz):
    ds = TDS(npz)
    idx = np.array([7, 1, 3, 9, 0, 4, 2, 10])
    batches = list(make_grain_loader(ds, idx, 3, shuffle=True, seed=5,
                                     num_epochs=2))
    stream = [i for x, _ in batches for i in _ids(x)]
    assert len(stream) == 2 * len(idx)
    epochs = [stream[:len(idx)], stream[len(idx):]]
    for epoch in epochs:
        assert sorted(epoch) == sorted(idx.tolist())
    assert epochs[0] != sorted(epochs[0])        # shuffled
    assert epochs[0] != epochs[1]                # anew each epoch
    for x, y in batches:
        xr, yr = ds.get_batch_raw(np.array(_ids(x)))
        np.testing.assert_array_equal(x, xr)
        np.testing.assert_array_equal(y, yr)
    again = list(make_grain_loader(ds, idx, 3, shuffle=True, seed=5,
                                   num_epochs=2))
    assert [_ids(x) for x, _ in again] == [_ids(x) for x, _ in batches]


def test_one_worker_process_gives_the_in_process_batches(npz):
    ds = TDS(npz)
    idx = np.arange(N)
    inproc = list(make_grain_loader(ds, idx, 4, seed=1))
    spawned = list(make_grain_loader(ds, idx, 4, seed=1, worker_count=1))
    assert len(spawned) == len(inproc) == 3
    for (xa, ya), (xb, yb) in zip(inproc, spawned):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_source_pickles_the_path_not_the_arrays(npz):
    ds = TDS(npz)
    src = _LoaderSource(ds, np.arange(4))
    blob = pickle.dumps(src)
    assert len(blob) < 4096          # X alone is ~11 KB here
    state = src.__getstate__()
    assert set(state) == {"npz_path", "stats", "indices"}
    clone = pickle.loads(blob)
    assert clone.dataset.mmap
    for a, b in zip(src[1], clone[1]):
        np.testing.assert_array_equal(a, b)

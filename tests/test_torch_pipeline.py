"""The port's loader against the JAX package's: the same batches in the same
order for three epochs, including a loader resumed at a later epoch;
``pad_batch``; the CPU prefetch."""

import numpy as np
import pytest
import torch

from unet_convlstm_tpu.data import pipeline as jpipe
from unet_convlstm_tpu_torch.data import pipeline as tpipe


class _Indices:
    """A dataset whose batches are their own indices."""

    def get_batch_raw(self, idx):
        return np.asarray(idx) * 10, np.asarray(idx)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (True, False),
                                          (False, False)])
def test_epoch_orders_equal_jax(shuffle, drop):
    idx = np.random.default_rng(3).permutation(23)[:19]
    kw = dict(batch_size=4, shuffle=shuffle, seed=5, drop_remainder=drop)
    jl = jpipe.SequenceLoader(_Indices(), idx, **kw)
    tl = tpipe.SequenceLoader(_Indices(), idx, **kw)
    assert len(tl) == len(jl)
    for _ in range(3):
        jb, tb = list(jl), list(tl)
        assert len(tb) == len(jb)
        for (a, b), (c, d) in zip(tb, jb):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    # a loader resumed at epoch 2 continues the sequence
    jl2 = jpipe.SequenceLoader(_Indices(), idx, **kw)
    jl2.epoch = 2
    tl2 = tpipe.SequenceLoader(_Indices(), idx, **kw)
    tl2.epoch = 2
    tl3 = tpipe.SequenceLoader(_Indices(), idx, **kw)
    third = [list(tl3) for _ in range(3)][2]
    for (a, _), (c, _), (e, _) in zip(list(tl2), list(jl2), third):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, e)


def test_pad_batch_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.random((3, 2, 4, 4, 2), np.float32)
    y = rng.random((3, 2, 4, 4, 1), np.float32)
    for bs in (3, 5):
        got, want = tpipe.pad_batch(x, y, bs), jpipe.pad_batch(x, y, bs)
        assert got[2] == want[2] == 3
        for a, b in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(a, b)


def test_prefetch_on_cpu_keeps_order_and_runs_ahead():
    pulled = []

    def batches():
        for i in range(5):
            pulled.append(i)
            yield np.full((2, 3), i, np.float32), np.arange(i + 1)

    out = tpipe.prefetch_to_device(batches(), size=2, device="cpu")
    first = next(out)
    assert pulled == [0, 1]               # the queue holds two batches
    second = next(out)
    assert pulled == [0, 1, 2]            # refilled as the consumer takes
    rest = [second] + list(out)
    assert [int(b[0][0, 0]) for b in [first] + rest] == list(range(5))
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for b in rest for t in b)
    np.testing.assert_array_equal(rest[-1][1].numpy(), np.arange(5))


def test_grain_loader_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 9"):
        tpipe.make_grain_loader(None, np.arange(3), 2)

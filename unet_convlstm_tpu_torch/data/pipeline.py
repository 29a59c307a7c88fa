"""Input pipeline: host batcher + device prefetch (counterpart of
unet_convlstm_tpu/data/pipeline.py).

* ``SequenceLoader`` serves RAW channels-last batches; the train step
  normalizes them on the device. Its per-epoch shuffle is the JAX loader's,
  order for order.
* ``prefetch_to_device`` copies the next batches to the card while the
  current step runs: pinned host buffers, copies on a side stream, and an
  event the consumer's stream waits on, so the host gather of batch k+1
  overlaps the device work of batch k.
* A batch's gather and its staging (the pinned copy and the copy's launch)
  are the ``data.gather`` and ``data.stage`` spans (``core/trace.py``).
* ``make_grain_loader`` is the JAX package's grain loader on PyTorch's
  ``DataLoader``: the same batches, gathered in worker processes when
  asked; its shuffled order is its own.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.utils.data

from ..core import trace
from ..core.dtypes import resolve_device


class SequenceLoader:
    """Epoch iterator over a dataset subset: yields raw NHWC (x, y) numpy
    batches. Shuffles with a per-epoch seeded rng (deterministic across
    restarts: ``epoch`` picks the order)."""

    def __init__(self, dataset, indices: np.ndarray, batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = False):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = self.indices
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            order = rng.permutation(order)
        self.epoch += 1
        stop = (len(order) // self.batch_size * self.batch_size
                if self.drop_remainder else len(order))
        for i in range(0, stop, self.batch_size):
            batch_idx = np.sort(order[i:i + self.batch_size])  # sorted gather
            with trace.span("data.gather"):
                batch = self.dataset.get_batch_raw(batch_idx)
            yield batch


def pad_batch(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad a ragged tail batch up to ``batch_size`` with zero rows; returns
    (x, y, n_real)."""
    n = x.shape[0]
    if n == batch_size:
        return x, y, n
    pad = batch_size - n
    x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    y = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
    return x, y, n


def prefetch_to_device(iterator, size: int = 2, device=None):
    """Yield each batch (a tuple of numpy arrays) as tensors on ``device``
    (the card unless another is named), ``size`` batches ahead of the
    consumer.

    On the card each array is copied into pinned host memory and on to the
    device on a side stream; the consumer's current stream waits on an
    event recorded after the copies, and each tensor is marked as used by
    that stream (``record_stream``), so the caching allocator does not hand
    its memory to the side stream while the step still reads it. Elsewhere
    it is a plain ``.to``."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if cuda else None

    def put(batch):
        with trace.span("data.stage"):
            if not cuda:
                return tuple(torch.from_numpy(np.asarray(a)).to(dev)
                             for a in batch), None
            with torch.cuda.stream(side):
                out = tuple(torch.from_numpy(np.ascontiguousarray(a))
                            .pin_memory().to(dev, non_blocking=True)
                            for a in batch)
                done = torch.cuda.Event()
                done.record(side)
            return out, done

    def take(entry):
        out, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for t in out:
                t.record_stream(consumer)
        return out

    queue = collections.deque()
    it = iter(iterator)
    for batch in itertools.islice(it, size):
        queue.append(put(batch))
    while queue:
        yield take(queue.popleft())
        for batch in itertools.islice(it, 1):
            queue.append(put(batch))


class _LoaderSource(torch.utils.data.Dataset):
    """One raw NHWC (x, y) sample a position of ``indices`` (the JAX
    package's ``_GrainSource``). Worker processes receive it pickled, and
    pickling ships the npz path, the stats manifest and the indices, never
    the X/Y arrays: each worker reopens the npz memory-mapped."""

    def __init__(self, dataset, indices: np.ndarray):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __getstate__(self):
        return {"npz_path": self.dataset.npz_path,
                "stats": self.dataset.stats.to_dict(),
                "indices": self.indices}

    def __setstate__(self, st):
        from ..ops.normalize import NormStats
        from .npz_dataset import NPZSequenceDataset

        self.indices = st["indices"]
        self.dataset = NPZSequenceDataset(
            st["npz_path"], stats=NormStats.from_dict(st["stats"]),
            mmap=True)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        x, y = self.dataset.get_batch_raw(self.indices[i:i + 1])
        return x[0], y[0]


class _EpochSampler(torch.utils.data.Sampler):
    """Positions 0..n-1 for each of ``num_epochs`` epochs, one stream
    (batches run on across an epoch's end, as grain's do); shuffled per
    epoch by a ``torch.Generator`` seeded with ``seed + epoch``."""

    def __init__(self, n: int, shuffle: bool, seed: int, num_epochs: int):
        self.n, self.shuffle = n, shuffle
        self.seed, self.num_epochs = seed, num_epochs

    def __len__(self) -> int:
        return self.n * self.num_epochs

    def __iter__(self):
        for epoch in range(self.num_epochs):
            if self.shuffle:
                g = torch.Generator().manual_seed(self.seed + epoch)
                yield from torch.randperm(self.n, generator=g).tolist()
            else:
                yield from range(self.n)


def _stack(samples):
    xs, ys = zip(*samples)
    return np.stack(xs), np.stack(ys)


def make_grain_loader(dataset, indices: np.ndarray, batch_size: int,
                      shuffle: bool = True, seed: int = 0,
                      worker_count: int = 0, num_epochs: int = 1):
    """The JAX package's grain-backed loader, on ``torch.utils.data.
    DataLoader``: yields the same raw NHWC (x, y) numpy batches as
    ``SequenceLoader`` over ``num_epochs`` passes of ``indices``, the last
    batch short (no remainder dropped). ``worker_count`` > 0 gathers the
    samples in that many spawned worker processes; 0 stays in-process.
    The shuffled order is this sampler's, not grain's."""
    source = _LoaderSource(dataset, indices)
    loader = torch.utils.data.DataLoader(
        source, batch_size=batch_size,
        sampler=_EpochSampler(len(source), shuffle, seed, num_epochs),
        drop_last=False, num_workers=worker_count, collate_fn=_stack,
        multiprocessing_context="spawn" if worker_count > 0 else None)
    return iter(loader)

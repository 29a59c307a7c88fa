"""Input pipeline: host batcher + device prefetch (counterpart of
unet_convlstm_tpu/data/pipeline.py).

* ``SequenceLoader`` serves RAW channels-last batches; the train step
  normalizes them on the device. Its per-epoch shuffle is the JAX loader's,
  order for order.
* ``prefetch_to_device`` copies the next batches to the card while the
  current step runs: pinned host buffers, copies on a side stream, and an
  event the consumer's stream waits on, so the host gather of batch k+1
  overlaps the device work of batch k.
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterator, Tuple

import numpy as np
import torch

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
            yield self.dataset.get_batch_raw(batch_idx)


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
        if not cuda:
            return tuple(torch.from_numpy(np.asarray(a)).to(dev)
                         for a in batch), None
        with torch.cuda.stream(side):
            out = tuple(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                        .to(dev, non_blocking=True) for a in batch)
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


def make_grain_loader(*args, **kwargs):
    """The grain-backed multi-worker loader of the JAX package: not ported
    (grain is not a dependency of the port; the loop uses
    ``SequenceLoader``)."""
    raise NotImplementedError(
        "make_grain_loader is not ported to unet_convlstm_tpu_torch yet "
        "(ROADMAP.md, queue A item 9: the rest of the surface)")

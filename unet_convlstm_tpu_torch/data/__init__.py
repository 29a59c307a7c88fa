"""Datasets and the input pipeline (counterpart of
unet_convlstm_tpu/data/): Moving-MNIST with velocity, the npz sequence
dataset, the loaders and the prefetch to the card; the batch gather runs
natively (``fast_gather``, ``native/``)."""

from .moving_mnist import (generate_moving_mnist,  # noqa: F401
                           load_mnist_digits, moving_mnist_to_xy,
                           save_moving_mnist_npz, synthetic_digit_bank)
from .npz_dataset import NPZSequenceDataset  # noqa: F401
from .pipeline import SequenceLoader, prefetch_to_device  # noqa: F401

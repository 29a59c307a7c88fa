"""Weights: carried over from the JAX package, the ResNet18 encoder's
``.pth`` files, and the reference's torch checkpoints (counterpart of
unet_convlstm_tpu/utils/)."""

from .torch_weights import load_torch_resnet18  # noqa: F401

"""unet_convlstm_tpu_torch — the PyTorch/CUDA port of unet_convlstm_tpu for
one NVIDIA H100 (sm_90a).

The JAX package ``unet_convlstm_tpu`` stays the reference. This package
mirrors its layout so that each module has a counterpart of the same name:

* ``core``    — the mixed-precision policy, device resolution and the
                counter-based random streams (threefry, Philox).
* ``ops``     — conv / pool / BatchNorm primitives, UNet blocks, ConvLSTM,
                normalization; ``ops.kernels`` holds the hand-written CUDA
                kernels (sources in ``csrc/``) beside their plain versions.
* ``models``  — TemporalUNetDualView, the sequence layout, the registry.
* ``train``   — checkpoint I/O (the reference's torch ``.pt`` format).
* ``utils``   — weights carried over from the JAX package's param trees.
* ``serve``   — the streaming predictor and its HTTP front end.
* ``datagen`` — stage B of the data chain: the deterministic renderer, the
                Monte-Carlo path tracer and the ``gen-renders`` driver.

It imports torch, never jax, and nothing of the JAX package. Entry points
run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

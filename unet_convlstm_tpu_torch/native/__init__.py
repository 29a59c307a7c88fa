"""The host kernels in C++ (counterpart of unet_convlstm_tpu/native/): the
fused batch gather and transpose behind ``data.fast_gather`` and the
Moving-MNIST paste, built with g++ at first use and bound with ctypes
(``build.load_hostio``). They run on the host's CPU."""

from .build import load_hostio  # noqa: F401

"""Mixed-precision policy (counterpart of unet_convlstm_tpu/core/dtypes.py).

The default policy computes convolutions in bf16 while parameters,
BatchNorm statistics and the ConvLSTM cell state stay in float32. The FP32
policy computes everything in float32 at full precision: on the card that
means TF32 off for cuDNN convolutions (on by default) and for matmuls, as
the JAX FP32 policy asks XLA for ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Parameters stay f32 and are cast per call to ``compute_dtype``."""
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32

    def cast_input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_param(self, p: torch.Tensor) -> torch.Tensor:
        # integer leaves (int8 kernels) keep their dtype, as in the JAX policy
        if not p.is_floating_point():
            return p
        return p.to(self.compute_dtype)

    @contextlib.contextmanager
    def precision(self):
        """Run f32 convs and matmuls at full f32 precision on the card
        under an f32 compute dtype; restore the previous flags after."""
        if self.compute_dtype != torch.float32:
            yield
            return
        with full_fp32():
            yield


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuDNN and cuBLAS inside the block, restored after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


DEFAULT_POLICY = Policy()
FP32_POLICY = Policy(compute_dtype=torch.float32)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no device given and no card present this raises; it
    never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")

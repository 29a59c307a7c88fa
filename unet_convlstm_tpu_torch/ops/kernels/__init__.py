"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterpart of unet_convlstm_tpu/ops/pallas/).

Each wrapper counts its kernel launches in a plain integer on its module;
``launch_counts`` reads them and ``reset_launches`` sets them to 0.
"""

from __future__ import annotations

from typing import Dict

from . import convlstm_fused, doubleconv_fused

KERNEL_MODULES = {"gate_update": convlstm_fused,
                  "conv3x3_fused": doubleconv_fused}


def launch_counts() -> Dict[str, int]:
    return {name: m.launches for name, m in KERNEL_MODULES.items()}


def reset_launches() -> None:
    for m in KERNEL_MODULES.values():
        m.launches = 0

"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterpart of unet_convlstm_tpu/ops/pallas/).

Each wrapper counts its kernel launches in a plain integer on its module;
``launch_counts`` reads them and ``reset_launches`` sets them to 0, with
the fused conv's count by route (``doubleconv_fused.launches_by_route``).
"""

from __future__ import annotations

from typing import Dict

from . import (chained_gather, channel_stats, convlstm_fused,
               doubleconv_fused, mc_sampler)

# kernel name → (module, the integer that counts its launches)
KERNEL_COUNTERS = {"gate_update": (convlstm_fused, "launches"),
                   "gate_update_bwd": (convlstm_fused, "bwd_launches"),
                   "conv3x3_fused": (doubleconv_fused, "launches"),
                   "mc_sample_flights": (mc_sampler, "launches"),
                   "mc_sample_flights_uniforms": (mc_sampler,
                                                  "uniforms_launches"),
                   "channel_sum_sumsq": (channel_stats, "launches"),
                   "chained_gather": (chained_gather, "launches")}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(m, attr)
            for name, (m, attr) in KERNEL_COUNTERS.items()}


def reset_launches() -> None:
    for m, attr in KERNEL_COUNTERS.values():
        setattr(m, attr, 0)
    for route in doubleconv_fused.launches_by_route:
        doubleconv_fused.launches_by_route[route] = 0

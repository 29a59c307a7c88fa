"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (counterpart of unet_convlstm_tpu/ops/pallas/).

Each wrapper counts its kernel launches in a plain integer on its module;
``launch_counts`` reads them and ``reset_launches`` sets them to 0, with
the gate update forward's, the fused conv's and the int8 conv's counts by
route (``convlstm_fused.launches_by_route``,
``doubleconv_fused.launches_by_route``, ``conv_int8.launches_by_route``)
and the int8 conv's by entry (``conv_int8.launches_by_entry``).
``save_launches`` and ``launches_with`` carry the counts of a driver's
child processes to the driver (``scripts/``).
"""

from __future__ import annotations

import json
import os
from typing import Dict

from . import (chained_gather, channel_stats, conv_int8, convlstm_fused,
               doubleconv_fused, mc_sampler)

# kernel name → (module, the integer that counts its launches)
KERNEL_COUNTERS = {"gate_update": (convlstm_fused, "launches"),
                   "gate_update_bwd": (convlstm_fused, "bwd_launches"),
                   "conv3x3_fused": (doubleconv_fused, "launches"),
                   "mc_sample_flights": (mc_sampler, "launches"),
                   "mc_sample_flights_uniforms": (mc_sampler,
                                                  "uniforms_launches"),
                   "channel_sum_sumsq": (channel_stats, "launches"),
                   "chained_gather": (chained_gather, "launches"),
                   "conv_int8": (conv_int8, "launches")}


def launch_counts() -> Dict[str, int]:
    return {name: getattr(m, attr)
            for name, (m, attr) in KERNEL_COUNTERS.items()}


def reset_launches() -> None:
    for m, attr in KERNEL_COUNTERS.values():
        setattr(m, attr, 0)
    for by_route in (convlstm_fused.launches_by_route,
                     doubleconv_fused.launches_by_route,
                     conv_int8.launches_by_route,
                     conv_int8.launches_by_entry):
        for route in by_route:
            by_route[route] = 0


def save_launches(path: str) -> None:
    """Add this process's launch counts to those in the JSON file ``path``
    (created when absent)."""
    total = launches_with(path)
    with open(path, "w") as f:
        json.dump(total, f)


def launches_with(*paths: str) -> Dict[str, int]:
    """This process's launch counts plus those saved in each of ``paths``
    that exists."""
    total = launch_counts()
    for path in paths:
        if os.path.exists(path):
            with open(path) as f:
                for name, n in json.load(f).items():
                    total[name] = total.get(name, 0) + n
    return total

"""Volume gathers of a stacked payload (counterpart of
unet_convlstm_tpu/ops/gather.py).

Fields read at the same voxel ride one ``[..., C]`` payload volume, so a
lookup is one advanced-indexing gather that returns all C values of each
voxel; fields are selected after the gather (``[..., i]``).
"""

from __future__ import annotations

import torch


def stack_volume(*fields: torch.Tensor) -> torch.Tensor:
    """Stack same-shape volumes into one ``[..., C]`` payload volume. A
    single field is stacked with a copy of itself (C=2), as in the JAX
    package, so the two packages hold the same payloads."""
    if len(fields) == 1:
        fields = (fields[0], fields[0])
    return torch.stack(fields, dim=-1)


def payload_lookup(vol: torch.Tensor, gz, gy, gx) -> torch.Tensor:
    """The full ``[..., C]`` payload at integer voxel indices of a
    ``[Z, Y, X, C]`` volume; the indices broadcast together."""
    return vol[gz, gy, gx]

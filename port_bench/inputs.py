"""What a run feeds both sides, made from ``--seed``: the weights (one
state dict in the reference's names, drawn on the device in one call),
the training pool in the npz dataset's layout, the served streams' frame
blocks, and the normalization manifest, worked out by the benchmark's own
arithmetic from the pool."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .reference import calibrate_bn, family

# raw value ranges (the configuration file states them): radiance in
# [0, X_MAX), velocities normal with this spread in m/s
X_MAX = 2.5
Y_STD = 4.0


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def make_state(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of the model, float32 on ``device``: conv
    weights and biases uniform in +-1/sqrt(fan_in) (torch's default init;
    a transposed conv's fan is its out channels x k x k, as torch computes
    it), BatchNorm at its identity (weight 1, bias 0, mean 0, var 1)."""
    specs = family(m).specs(m)
    sizes = [math.prod(s) for _, s, k in specs if k in ("w", "b")]
    u = torch.rand(sum(sizes), generator=_generator(seed, device),
                   device=device)
    state, off, bound = {}, 0, 1.0
    for name, shape, kind in specs:
        if kind in ("w", "b"):
            if kind == "w":
                bound = 1.0 / math.sqrt(shape[1] * shape[2] * shape[3])
            n = math.prod(shape)
            state[name] = (u[off:off + n].view(shape) * 2.0 - 1.0) * bound
            off += n
        elif kind == "bn_count":
            state[name] = torch.zeros((), dtype=torch.long, device=device)
        else:
            fill = 1.0 if kind in ("bn_w", "bn_var") else 0.0
            state[name] = torch.full(shape, fill, device=device)
    return state


def seeded_state(m: dict, seed: int, device, image, seq_len: int,
                 calib_sequences: int = 2) -> Dict[str, torch.Tensor]:
    """``make_state`` with its BatchNorm running statistics calibrated, the
    weights a served model gets: one train-mode pass of the plain
    reference (float32, TF32 off) over ``calib_sequences`` seeded
    sequences of normalized frames, so that every BatchNorm normalizes its
    activations as a trained model's roughly would (at identity, eval-mode
    BatchNorm lets the random network's activations fade layer by
    layer)."""
    from .reference.train import no_tf32

    state = make_state(m, seed, device)
    H, W = image
    x = torch.rand((calib_sequences, seq_len, 2, H, W),
                   generator=_generator(seed + 3, device), device=device)
    with no_tf32():     # x: normalized frames (raw U[0, X_MAX) / X_MAX)
        stats = calibrate_bn(state, m, x)
    state.update(stats)
    return state


def to_host(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A copy on the host (never the same tensors, on the CPU too)."""
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


def to_device(state: Dict[str, torch.Tensor], device):
    """A copy on ``device`` (never the same tensors)."""
    return {k: v.to(device, copy=True) for k, v in state.items()}


def make_pool(seed: int, n: int, T: int, H: int, W: int, device):
    """n sequences, raw, in the npz dataset's layout: X [n, T, 2, H, W]
    and Y [n, T, 1, H, W] float32 host arrays. Scenes differ as real ones
    do: each sequence has its own brightness (radiance up to between a
    tenth of X_MAX and X_MAX) and its own wind (velocity spread between
    Y_STD / 8 and 2 Y_STD, log-uniform)."""
    g = _generator(seed + 1, device)
    bright = 10.0 ** (-torch.rand((n, 1, 1, 1, 1), generator=g,
                                  device=device))
    wind = 2.0 ** (4.0 * torch.rand((n, 1, 1, 1, 1), generator=g,
                                    device=device) - 3.0)
    X = (torch.rand((n, T, 2, H, W), generator=g, device=device)
         * (X_MAX * bright)).cpu().numpy()
    Y = (torch.randn((n, T, 1, H, W), generator=g, device=device)
         * (Y_STD * wind)).cpu().numpy()
    return X, Y


def make_streams(seed: int, count: int, frames: int, batch: int, H: int,
                 W: int, device) -> List[List[np.ndarray]]:
    """``count`` runs of a served stream, each ``frames`` raw frame blocks
    [batch, 1, H, W, 2] float32 (the served layout) on the host."""
    g = _generator(seed + 2, device)
    x = (torch.rand((count, frames, batch, 1, H, W, 2), generator=g,
                    device=device) * X_MAX).cpu().numpy()
    return [[np.ascontiguousarray(f) for f in run] for run in x]


def norm_stats(Y: np.ndarray, x_max: float, lower: float = 0.00001,
               upper: float = 99.99999, pct: float = 99.0,
               sample: int = 8) -> dict:
    """The normalization manifest from the first ``sample`` sequences of
    the pool: the dataset's rule (X divided by max(max X, 1); Y clipped to
    its [lower, upper] percentiles, asinh-transformed by the ``pct``
    percentile of |Y|, mapped to [-1, 1] by the transformed percentiles)."""
    y = np.asarray(Y[:sample], np.float64).ravel()
    min_vel = float(np.percentile(y, lower))
    max_vel = float(np.percentile(y, upper))
    scale = float(np.percentile(np.abs(y), pct)) or 1.0
    t = np.arcsinh(y / scale)
    return {"norm_const": max(float(x_max), 1.0), "min_vel": min_vel,
            "max_vel": max_vel, "y_scale": scale,
            "trans_min": float(np.percentile(t, lower)),
            "trans_max": float(np.percentile(t, upper)),
            "y_transform": "asinh", "clip_outliers": True,
            "mask_threshold": 1.1}


class PoolDataset:
    """The training pool behind the port's ``SequenceLoader``: the npz
    dataset's ``get_batch_raw`` (the port's host gather and transpose) over
    arrays held in memory, recording the indices of every batch it
    serves."""

    def __init__(self, X: np.ndarray, Y: np.ndarray, gather):
        self.X, self.Y = X, Y
        self.N, self.T = X.shape[:2]
        self._gather = gather
        self.served: List[np.ndarray] = []

    def __len__(self) -> int:
        return self.N

    def get_batch_raw(self, indices):
        self.served.append(np.array(indices))
        return self._gather(self.X, indices), self._gather(self.Y, indices)

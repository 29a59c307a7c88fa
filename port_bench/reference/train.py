"""Plain PyTorch reference of a training step and of a served stream.

The arithmetic of https://github.com/dordanino12/unet-convlstm ``main.py``:
inputs divided by the dataset's maximum; targets clipped, ``asinh``
transformed and mapped to [-1, 1]; the velocity-weighted L1 (weight 1 +
4|y|^3) plus 0.005 times the L1 of the spatial finite differences;
gradients clipped to a global norm of 1.0 (scaled by 1/norm only when the
norm is at least 1.0, optax's rule, which the JAX reimplementation of the
reference uses); AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled decay);
BatchNorm running statistics committed after the update. Serving denormalizes
the output with the inverse transform. Float32 with TF32 off unless a
``quant`` function lowers the precision of every convolution.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch

from . import family, layers


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def normalize_x(x, stats: dict):
    return x / stats["norm_const"]


def normalize_y(y, stats: dict):
    y = torch.clamp(y, stats["min_vel"], stats["max_vel"])
    t = torch.asinh(y / stats["y_scale"])
    return 2.0 * (t - stats["trans_min"]) / (stats["trans_max"]
                                             - stats["trans_min"]) - 1.0


def denormalize_y(y, stats: dict):
    t = (y + 1.0) / 2.0 * (stats["trans_max"] - stats["trans_min"]) \
        + stats["trans_min"]
    return torch.sinh(t) * stats["y_scale"]


def loss_fn(y_pred, y, grad_weight: float = 0.005):
    """[B, T, C, H, W]; no mask (the configurations train unmasked)."""
    l1 = (torch.abs(y_pred - y) * (1.0 + 4.0 * torch.abs(y) ** 3)).mean()
    dxp = y_pred[..., :-1, 1:] - y_pred[..., :-1, :-1]
    dxg = y[..., :-1, 1:] - y[..., :-1, :-1]
    dyp = y_pred[..., 1:, :-1] - y_pred[..., :-1, :-1]
    dyg = y[..., 1:, :-1] - y[..., :-1, :-1]
    grad = (torch.abs(dxp - dxg) + torch.abs(dyp - dyg)).mean()
    return l1 + grad_weight * grad


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def train_steps(state: Dict[str, torch.Tensor], m: dict, hp: dict,
                stats: dict, batches: List[tuple], device,
                quant: layers.Quant = None) -> dict:
    """Run ``len(batches)`` training steps from ``state`` (a state dict on
    ``device``, consumed) on raw batches (x [B,T,2,H,W], y [B,T,1,H,W]
    numpy). Returns each step's loss, the first step's clipped gradient
    norm per trainable leaf, each running statistic's change by the
    first step's commit, and after the last step each trainable leaf's
    change norm."""
    P = {k: v.float() if v.is_floating_point() else v
         for k, v in state.items()}
    fam = family(m)
    names = [k for k, _, kind in fam.specs(m)
             if kind in ("w", "b", "bn_w", "bn_b") and fam.trainable(m, k)]
    start = {k: P[k].detach().clone() for k in names}
    stat_names = [k for k in P if k.endswith(("running_mean",
                                              "running_var"))]
    stats0 = {k: P[k].clone() for k in stat_names}
    commit = None
    for k in names:
        P[k] = P[k].detach().clone().requires_grad_(True)
    opt = torch.optim.AdamW([P[k] for k in names], lr=hp["lr"],
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=hp["weight_decay"], foreach=False)
    losses, grad_norms = [], None
    with no_tf32():
        for step, (x_raw, y_raw) in enumerate(batches):
            x = normalize_x(_to_device(x_raw, device), stats)
            y = normalize_y(_to_device(y_raw, device), stats)
            y_pred, _, new = fam.forward(P, m, x, train=True, quant=quant)
            loss = loss_fn(y_pred, y, hp["grad_weight"])
            loss.backward()
            grads = [P[k].grad for k in names]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            if norm >= hp["grad_clip"]:
                for g in grads:
                    g.mul_(hp["grad_clip"] / norm)
            if step == 0:
                grad_norms = {k: float(torch.linalg.vector_norm(g))
                              for k, g in zip(names, grads)}
            opt.step()
            opt.zero_grad(set_to_none=True)
            with torch.no_grad():
                for k, v in new.items():
                    P[k] = v
                if step == 0:
                    commit = {k: float(torch.linalg.vector_norm(
                        P[k] - stats0[k])) for k in stat_names}
            losses.append(float(loss.detach()))
            del y_pred, loss, grads, new
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(P[k].detach() - v))
                  for k, v in start.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change": change,
            "commit": commit}


@torch.no_grad()
def serve_stream(state: Dict[str, torch.Tensor], m: dict, stats: dict,
                 frames: List[np.ndarray], device, block: int = 64,
                 quant: layers.Quant = None) -> List[torch.Tensor]:
    """The denormalized outputs of one session's frames, each raw [B, 1, H,
    W, C] numpy (the served layout), from a zero state, in blocks of
    ``block`` rows. Returns each frame's [B, H, W] on the host."""
    P = {k: v.float() if v.is_floating_point() else v
         for k, v in state.items()}
    fam = family(m)
    B = frames[0].shape[0]
    outs = [[] for _ in frames]
    with no_tf32():
        for r0 in range(0, B, block):
            carry: Optional[dict] = None
            for i, f in enumerate(frames):
                x = _to_device(f[r0:r0 + block], device)
                x = normalize_x(x.permute(0, 1, 4, 2, 3), stats)
                y, carry, _ = fam.forward(P, m, x, state=carry,
                                             train=False, quant=quant)
                outs[i].append(denormalize_y(y[:, 0, 0], stats).cpu())
    return [torch.cat(o) for o in outs]

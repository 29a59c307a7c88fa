"""Autoregressive / incremental-context rollout (counterpart of
unet_convlstm_tpu/eval/rollout.py).

The reference's rollout video (test.py:305-316) re-runs the model on every
growing prefix, O(T²). Here streaming is the first-class API: the (h, c)
carries advance one frame at a time, so a length-T rollout is O(T) with
the same outputs. ``rollout_prefix_rerun`` keeps the reference's prefix
semantics for comparison.

* ``rollout_streaming`` — one forward per frame, the carries on the card
  between frames (the serving path);
* ``rollout_scan`` — the whole sequence in one forward from ``state``: the
  encoder and decoder run batched over T·B frames and only the ConvLSTMs
  walk time, which is what the JAX ``lax.scan`` gives as one dispatch.
  Same outputs and final state as streaming. The JAX function casts f32
  zero states to the step's h dtype before its scan (rollout.py:128-133);
  here ``ops.convlstm.convlstm`` coerces any carry it is given to h in the
  compute dtype and c in f32 before its first step, so f32 zero states
  from ``init_state_fn`` align the same way;
* ``rollout_prefix_rerun`` — the reference's O(T²) prefix re-runs;
* ``frame_errors`` — per-frame MAE / RMSE / ME of a rollout (numpy).

The JAX module caches one jitted step per ``apply_fn`` (``_cached_jit``);
PyTorch runs eagerly and traces nothing, so there is nothing to cache.
Everything runs under ``torch.inference_mode()`` on ``x_seq``'s device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import data_mesh



@torch.inference_mode()
def rollout_streaming(apply_fn: Callable, model, x_seq: torch.Tensor,
                      init_state_fn: Callable,
                      state: Optional[Dict[str, Any]] = None
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Feed frames one at a time, carrying the recurrent state.

    x_seq [B, T, H, W, C] → (y_seq [B, T, H, W, out], final state). Each
    frame costs the same: the serving path."""
    B, T, H, W, _ = x_seq.shape
    if state is None:
        state = init_state_fn(B, H, W, device=x_seq.device)
    outs: List[torch.Tensor] = []
    for t in range(T):
        y_t, state, _ = apply_fn(model, x_seq[:, t:t + 1], state=state,
                                 train=False)
        outs.append(y_t)
    return torch.cat(outs, dim=1), state


@torch.inference_mode()
def rollout_scan(apply_fn: Callable, model, x_seq: torch.Tensor,
                 init_state_fn: Callable,
                 state: Optional[Dict[str, Any]] = None,
                 mesh=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The whole sequence in one forward from ``state`` (zero states when
    None): the same outputs and final state as ``rollout_streaming``.

    ``mesh`` (``parallel.Mesh`` of D ranks): data parallel, as the JAX
    rollout shards the batch and its carries over 'data'. Every rank passes
    the whole batch (and state); each runs its B/D rows, and the outputs and
    final states are gathered in row order, so every rank returns the
    one-device result. B must be divisible by D."""
    mesh = data_mesh(mesh)
    B, T, H, W, _ = x_seq.shape
    if mesh is not None and B % mesh.data:
        raise ValueError(f"rollout batch {B} not divisible by mesh data "
                         f"degree {mesh.data}")
    if state is None:
        state = init_state_fn(B, H, W, device=x_seq.device)
    if mesh is None:
        y_seq, state, _ = apply_fn(model, x_seq, state=state, train=False)
        return y_seq, state
    rows = mesh.rows(B)
    y_loc, state_loc, _ = apply_fn(model, x_seq[rows],
                                   state=_map_rows(state, lambda t: t[rows]),
                                   train=False)
    return (mesh.all_gather(y_loc),
            _map_rows(state_loc, lambda t: mesh.all_gather(t)))


def _map_rows(tree, fn):
    """``fn`` applied to every tensor of a recurrent state (dicts, lists
    and tuples of [B, ...] tensors)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_rows(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_rows(v, fn) for v in tree)
    return tree


@torch.inference_mode()
def rollout_prefix_rerun(apply_fn: Callable, model, x_seq: torch.Tensor
                         ) -> List[torch.Tensor]:
    """Reference semantics (test.py:305-316): for each prefix length t_len,
    run the model from scratch on x_seq[:, :t_len] and keep the last frame.
    Returns T tensors [B, H, W, out]. O(T²): for parity evaluation only."""
    T = x_seq.shape[1]
    outs = []
    for t_len in range(1, T + 1):
        y_seq, _, _ = apply_fn(model, x_seq[:, :t_len], train=False)
        outs.append(y_seq[:, -1])
    return outs


def frame_errors(gt_denorm, pred_denorm, mask_seq) -> Dict[str, List[float]]:
    """Per-frame MAE, RMSE and mean error of [T, H, W] numpy maps, over the
    masked pixels (all pixels of a frame whose mask is empty): the
    reference's last-frame printout (test.py:333-351) for every frame."""
    stats: Dict[str, List[float]] = {"mae": [], "rmse": [], "me": []}
    for t in range(len(gt_denorm)):
        diff = pred_denorm[t] - gt_denorm[t]
        m = mask_seq[t] > 0
        d = diff[m] if m.any() else diff.ravel()
        stats["mae"].append(float(np.mean(np.abs(d))))
        stats["rmse"].append(float(np.sqrt(np.mean(d ** 2))))
        stats["me"].append(float(np.mean(d)))
    return stats

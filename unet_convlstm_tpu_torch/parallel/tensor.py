"""Tensor parallelism: conv kernels split by output channel over the mesh's
``model`` axis (counterpart of what XLA does for the JAX package when its
``MeshRules(shard_model_channels=True)`` shards a train state).

* ``shard_model`` narrows a whole model, in place, to this rank's shards:
  each parameter whose spec (``MeshRules.tree_sharding``) names 'model'
  keeps block m of its output axis (model rank m, blocks in rank order)
  and carries that axis as its ``model_axis`` attribute. Everything else
  (biases, BatchNorm parameters and statistics, the kernels the model
  degree does not divide) stays whole and replicated.
  ``full_state_dict`` is its inverse (the shards gathered, a one-process
  state dict) and ``load_full_state_dict`` narrows a one-process state
  dict into a sharded model.
* A conv whose weight is a shard runs column-parallel: its input goes
  through ``copy_to_model`` (identity; the backward sums the input's
  gradient over the model group, since each rank's conv sees only its
  output channels), the rank computes its block of output channels, and
  ``gather_from_model`` puts the blocks together along the channel axis
  (the backward keeps this rank's block of the gradient). The bias, whole,
  is added after the gather, so its gradient is the whole one on every
  rank. ``ops/conv.py``, ``ops/blocks.py`` (K2's fused DoubleConv) and
  ``ops/convlstm.py`` call the pair.

The model ranks hold the same rows and compute the replicated parts of the
step from the same bits, so those parts stay bit-identical across the
model group; the collectives are the mesh's all-reduce and all-gather.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from .mesh import Mesh, TreeSharding


def model_axis(t) -> Optional[int]:
    """The axis a tensor-parallel shard is split on, or None (a whole,
    replicated tensor)."""
    return getattr(t, "model_axis", None)


def as_shard_of(t: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """``t`` (a tensor derived from ``param`` along its other axes: cast,
    laid out, sliced by input channel) marked as the same shard."""
    axis = model_axis(param)
    if axis is not None and t is not param:
        t.model_axis = axis
    return t


def shard_mesh(weight: torch.Tensor, mesh) -> Optional[Mesh]:
    """The mesh over which ``weight`` is split, or None for a whole weight.
    A shard needs a mesh with a model axis: running it without one would
    compute another function, so that raises."""
    if model_axis(weight) is None:
        return None
    if mesh is None or mesh.model == 1:
        raise ValueError("a tensor-parallel weight shard runs only with its "
                         "mesh (mesh= with model > 1)")
    return mesh


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        dtype = g.dtype
        # partial sums of a 16-bit gradient add in f32, rounded once
        wide = g.float() if dtype in (torch.bfloat16, torch.float16) else g
        return ctx.mesh.all_reduce(wide, axis="model").to(dtype), None


class _GatherFromModel(torch.autograd.Function):
    """The model ranks' blocks concatenated along ``dim`` in rank order;
    the backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, dim=dim, axis="model")

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.block(g, ctx.dim, "model").contiguous(), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` as the input of this rank's block of a column-parallel op."""
    return _CopyToModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh: Mesh,
                      dim: int = -1) -> torch.Tensor:
    """This rank's block along ``dim`` → the whole tensor (a contiguous
    NHWC tensor for an activation block)."""
    return _GatherFromModel.apply(x, mesh, dim % x.dim())


def local_block(v: Optional[torch.Tensor], mesh: Optional[Mesh]
                ) -> Optional[torch.Tensor]:
    """This rank's block of a whole (replicated) per-channel vector, such
    as the bias a kernel adds to its block of output channels; the
    gradient of the whole vector is then summed over the model group."""
    if v is None or mesh is None:
        return v
    return mesh.block(copy_to_model(v, mesh), 0, "model")


# ---------------------------------------------------------------------------
# The model's shards
# ---------------------------------------------------------------------------

def shard_model(model: nn.Module, sharding: TreeSharding) -> nn.Module:
    """Narrow ``model`` in place to this rank's shards of ``sharding``
    (``MeshRules(shard_model_channels=True).tree_sharding`` of its state):
    each parameter split over 'model' is replaced by a parameter holding
    block ``model_rank`` of its output axis, marked with ``model_axis``.
    Returns the model."""
    mesh = sharding.mesh
    for name, p in list(model.named_parameters()):
        axis = sharding.model_axis(name)
        if axis is None or mesh.model == 1:
            continue
        if model_axis(p) is not None:
            raise ValueError(f"{name} is a shard already")
        owner, leaf = _owner(model, name)
        q = nn.Parameter(mesh.block(p.detach(), axis, "model").contiguous(),
                         requires_grad=p.requires_grad)
        q.model_axis = axis
        setattr(owner, leaf, q)
    return model


def _owner(model: nn.Module, name: str):
    *path, leaf = name.split(".")
    return model.get_submodule(".".join(path)), leaf


def check_sharded(model: nn.Module, sharding: TreeSharding) -> None:
    """Raise unless ``model`` holds exactly the shards ``sharding`` names
    (``shard_model`` was applied)."""
    for name, p in model.named_parameters():
        want = sharding.model_axis(name) if sharding.mesh.model > 1 else None
        if model_axis(p) != want:
            raise ValueError(
                f"{name}: the model is not sharded as the sharding says "
                f"(model axis {model_axis(p)}, expected {want}): apply "
                f"parallel.tensor.shard_model(model, sharding) first")


def full_state_dict(model: nn.Module, mesh=None) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every shard gathered over the model
    group (a collective: every rank calls it): the one-process state
    dict. Without shards, the state dict itself."""
    state = model.state_dict()
    shards = {n: model_axis(p) for n, p in model.named_parameters()
              if model_axis(p) is not None}
    if not shards:
        return state
    if mesh is None or mesh.model == 1:
        raise ValueError("gathering a tensor-parallel model needs its mesh")
    whole = mesh.gather_blocks([state[n] for n in shards],
                               list(shards.values()), "model")
    state.update(zip(shards, whole))
    return state


def load_full_state_dict(model: nn.Module,
                         state: Mapping[str, torch.Tensor],
                         mesh=None) -> None:
    """Load a one-process state dict into a (possibly) sharded model,
    strictly: each shard takes its block."""
    local = dict(state)
    for n, p in model.named_parameters():
        axis = model_axis(p)
        if axis is not None and n in local:
            local[n] = mesh.block(local[n], axis, "model")
    model.load_state_dict(local)

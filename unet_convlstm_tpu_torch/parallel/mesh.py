"""Data-parallel process groups and partition rules (counterpart of
unet_convlstm_tpu/parallel/mesh.py).

The JAX package describes its devices as a ``(data, model)`` mesh and lets
XLA insert the collectives under ``jit``. Here a ``Mesh`` describes a
``torch.distributed`` process group, one process a card (or a CPU
process), with the shape ``{"data": D, "model": 1}``, and the code calls
the collectives itself:

* a global batch of B rows is split into D blocks of B/D consecutive rows,
  rank r holding block r (``batch_sharding(mesh).local``), as a
  ``P("data")`` sharding lays the rows over the devices;
* the training step's BatchNorm statistics, loss denominators, gradients
  and metric sums are summed over the group, so a step computes the
  function one device computes on the global batch (what XLA does under
  ``jit``);
* ``MeshRules.opt_state_spec`` is the JAX rule that picks the dimension a
  ZeRO-1 optimizer moment is split on.

Tensor parallelism (``model > 1``) is not ported (ROADMAP.md, queue A item
7b). The mesh is passed explicitly to whatever runs on it (bound into
``apply_fn`` like the policy); there is no module-level group.

Collectives: NCCL for CUDA tensors, gloo for CPU tensors. The code calls
two, all-reduce (sum) and all-gather, and gloo takes CUDA tensors for both
(it copies them through the host itself), so several processes sharing one
card can run the data-parallel code over gloo.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

MODEL_PARALLEL = ("tensor parallelism (a mesh with model > 1) is not ported "
                  "to unet_convlstm_tpu_torch yet (ROADMAP.md, queue A item "
                  "7b)")
GROUP_TIMEOUT_S = 600      # init_group_from_env's collective timeout


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A process group seen as a ``{"data": D, "model": 1}`` mesh.
    ``group`` None is one process (D = 1, no collective runs)."""
    group: Optional[Any]
    data: int
    rank: int
    backend: str           # "nccl", "gloo", or "" without a group

    @property
    def shape(self):
        return {"data": self.data, "model": 1}

    @property
    def distributed(self) -> bool:
        """True when the collectives run (a group, even of one rank)."""
        return self.group is not None

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` rows."""
        if n % self.data:
            raise ValueError(f"batch {n} not divisible by mesh data degree "
                             f"{self.data}")
        b = n // self.data
        return slice(self.rank * b, (self.rank + 1) * b)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, as a new tensor (``t`` itself
        without a group). No gradient: see ``global_sum``."""
        if not self.distributed:
            return t
        buf = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, group=self.group)
        return buf

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        if not self.distributed:
            return t
        src = t.detach().contiguous()
        bufs = [torch.empty_like(src) for _ in range(self.data)]
        dist.all_gather(bufs, src, group=self.group)
        return torch.cat(bufs, dim=dim)


class _GlobalSum(torch.autograd.Function):
    """y = the sum of x over the ranks. Each rank's loss is its share of the
    global loss (the shares add up to it), so the cotangent of the global
    statistic is the sum of the ranks' cotangents: the backward sums the
    incoming gradient over the ranks too. The gradient all-reduce of the
    step then adds the ranks' parameter gradients once."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g), None


def global_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Differentiable sum of ``x`` over the mesh's ranks (``x`` itself with
    no mesh or no group)."""
    if mesh is None or not mesh.distributed:
        return x
    return _GlobalSum.apply(x, mesh)


def sum_gradients(grads: List[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Each gradient replaced, in place, by its sum over the ranks (one
    collective). Each rank's loss is its share of the global loss, so the
    sums are the global loss's gradients."""
    if mesh is None or not mesh.distributed or not grads:
        return
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def data_mesh(mesh) -> Optional[Mesh]:
    """A function's ``mesh=`` argument as the mesh whose collectives run,
    or None (no mesh, or one process without a group)."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh if mesh.distributed else None


def make_mesh(data: Optional[int] = None, model: int = 1,
              group=None) -> Mesh:
    """A ``(data, model)`` mesh over ``group`` (a ``torch.distributed``
    process group; ``dist.group.WORLD`` for the default one). ``data``
    None: the group's size. Without a group only ``data`` 1 (one process)
    is possible. ``model`` > 1 raises: tensor parallelism is item 7b."""
    if model != 1:
        raise NotImplementedError(f"{MODEL_PARALLEL}: model={model}")
    if group is None:
        if (data or 1) != 1:
            raise ValueError(f"a mesh of data={data} needs a process group "
                             f"of {data} ranks (init_group_from_env under "
                             f"torchrun)")
        return Mesh(None, 1, 0, "")
    size = dist.get_world_size(group)
    if data is None:
        data = size
    if data * model != size:
        raise ValueError(f"mesh {data}x{model} does not match the process "
                         f"group's {size} ranks")
    return Mesh(group, data, dist.get_rank(group),
                str(dist.get_backend(group)))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies over the mesh: ``spec`` ``("data",)`` splits its
    leading axis over the ranks, ``()`` replicates it."""
    mesh: Mesh
    spec: Tuple

    def local(self, a):
        """This rank's part of a global array (tensor or numpy)."""
        if self.spec[:1] == ("data",):
            return a[self.mesh.rows(a.shape[0])]
        return a


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis (batch) sharding for [B, ...] arrays."""
    return Sharding(mesh, ("data",))


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_batch_spec(ndim: int) -> Tuple:
    """The spec sharding only the leading (batch) axis."""
    return ("data",) + (None,) * (ndim - 1)


# A 4-D weight in torch's layout (Conv2d [out, in, kh, kw], ConvTranspose2d
# [in, out, kh, kw]) and in the JAX package's (HWIO, and HWOI for the
# transposed kernel): JAX axis j is torch axis _JAX_TO_TORCH[j] for both.
_JAX_TO_TORCH = (2, 3, 1, 0)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """The JAX package's ZeRO-1 partition rule, on the port's leaves:
    ``path`` is a parameter's name split at the dots, ``leaf`` the tensor in
    torch's layout. A spec is a tuple with one entry per axis ("data" or
    None) and the empty tuple for a replicated leaf, as a PartitionSpec.
    The JAX rules' tensor-parallel part (conv out-channels on 'model') comes
    with item 7b."""
    mesh: Mesh
    shard_opt_state_data: bool = False  # ZeRO-1: optimizer moments on 'data'

    def opt_state_spec(self, path, leaf) -> Tuple:
        """ZeRO-1: a floating moment on 'data' along its largest dimension
        that the data degree divides. The dimensions are ranked in the JAX
        layout, so a tie goes where the JAX rule puts it (the first largest
        JAX axis)."""
        data_size = self.mesh.shape["data"]
        ndim = leaf.dim()
        if (not self.shard_opt_state_data or data_size <= 1 or ndim == 0
                or not leaf.is_floating_point()):
            return ()
        order = _JAX_TO_TORCH if ndim == 4 else tuple(range(ndim))
        free = [a for a in order if leaf.shape[a] % data_size == 0]
        if not free:
            return ()
        spec = [None] * ndim
        spec[max(free, key=lambda a: leaf.shape[a])] = "data"  # first tie
        return tuple(spec)

    def zero1_axis(self, name: str, leaf) -> Optional[int]:
        """The torch axis ``opt_state_spec`` splits over 'data', or None."""
        spec = self.opt_state_spec(tuple(name.split(".")), leaf)
        return spec.index("data") if "data" in spec else None


# ---------------------------------------------------------------------------
# The group of a torchrun launch
# ---------------------------------------------------------------------------

def init_group_from_env(device=None, data: Optional[int] = None):
    """The default process group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL for the card,
    where LOCAL_RANK picks the card, gloo for the CPU; an explicit
    timeout. ``data``: the data degree the caller expects, which must be
    WORLD_SIZE. Returns (mesh, device)."""
    if "WORLD_SIZE" not in os.environ:
        raise ValueError(
            f"a data-parallel run (data={data}) needs one process a rank: "
            f"launch it under torchrun (torchrun --nproc-per-node {data} "
            f"-m unet_convlstm_tpu_torch ...)")
    world = int(os.environ["WORLD_SIZE"])
    if data is not None and world != data:
        raise ValueError(f"WORLD_SIZE={world} but the run asks for "
                         f"data={data} ranks: launch as many processes as "
                         f"mesh_data")
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "none")
    if dev.type == "none":
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method="env://",
            rank=int(os.environ["RANK"]), world_size=world,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    return make_mesh(data, group=dist.group.WORLD), dev

"""Process groups as a ``(data, model)`` mesh, and the partition rules
(counterpart of unet_convlstm_tpu/parallel/mesh.py).

The JAX package describes its devices as a ``(data, model)`` mesh and lets
XLA insert the collectives under ``jit``. Here a ``Mesh`` describes a
``torch.distributed`` process group, one process a card (or a CPU
process), laid out as a D x M grid, and the code calls the collectives
itself. Global rank ``d * M + m`` sits at (d, m): ``model`` is the
fastest-varying axis, as in the JAX device order.

* ``data``: a global batch of B rows is split into D blocks of B/D
  consecutive rows, data rank d holding block d (``batch_sharding(mesh)
  .local``), as a ``P("data")`` sharding lays the rows over the devices.
  The training step's BatchNorm statistics, loss denominators, gradients
  and metric sums are summed over the data group (the ranks with the same
  m), so a step computes the function one device computes on the global
  batch (what XLA does under ``jit``).
* ``model``: tensor parallelism. ``MeshRules.param_spec`` splits each 4-D
  floating conv kernel by output channel over the model group (the ranks
  with the same d, which hold the same rows); ``parallel/tensor.py``
  narrows a model to its shards and runs each split conv column-parallel
  (its output block gathered over the model group). Everything else is
  replicated, and bit-identical across the model group.
* ``MeshRules.opt_state_spec`` is the JAX rule that picks the dimension a
  ZeRO-1 optimizer moment is split on over ``data``, on top of the channel
  rule (the ``model`` axis is never free).

The mesh is passed explicitly to whatever runs on it (bound into
``apply_fn`` like the policy); there is no module-level group.

Collectives: NCCL for CUDA tensors, gloo for CPU tensors. The code calls
all-reduce (sum) and all-gather, and gloo takes CUDA tensors for both
(it copies them through the host itself), so several processes sharing one
card can run the parallel code over gloo. The pipelined ConvLSTM
(``ops/convlstm_sp.py``) also hands a tensor to the next rank along an
axis (``Mesh.ring_shift``, a send and a receive), which over gloo stages a
CUDA tensor through the host itself.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 600      # init_group_from_env's collective timeout


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A process group seen as a ``{"data": D, "model": M}`` mesh.
    ``group`` None is one process (D = M = 1, no collective runs).
    ``rank`` is the process's rank in ``group``; ``data_group`` (None:
    ``group`` itself, for M = 1) and ``model_group`` are its row and
    column of the grid."""
    group: Optional[Any]
    data: int
    rank: int
    backend: str           # "nccl", "gloo", or "" without a group
    model: int = 1
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    @property
    def shape(self):
        return {"data": self.data, "model": self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

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
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def _groups(self, axis: str):
        if axis == "data":
            return (self.data_group if self.data_group is not None
                    else self.group), self.data
        return self.model_group, self.model

    def all_reduce(self, t: torch.Tensor, axis: str = "data"
                   ) -> torch.Tensor:
        """The sum of ``t`` over the ranks of ``axis`` (the data group by
        default), as a new tensor (``t`` itself without a group, or for
        the model axis of M = 1). No gradient: see ``global_sum``."""
        group, size = self._groups(axis)
        if not self.distributed or (axis == "model" and size == 1):
            return t
        buf = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, group=group)
        return buf

    def block(self, t: torch.Tensor, dim: int,
              axis: str = "data") -> torch.Tensor:
        """This rank's block of ``t`` along ``dim``: ``t`` split into as
        many blocks as ``axis`` has ranks, in rank order."""
        rank = self.data_rank if axis == "data" else self.model_rank
        n = t.shape[dim] // self.shape[axis]
        return t.narrow(dim, rank * n, n)

    def gather_blocks(self, blocks: List[torch.Tensor], dims: List[int],
                      axis: str = "data") -> List[torch.Tensor]:
        """The whole tensors of the ranks' blocks over ``axis`` (one
        all-gather of one dtype): block i concatenated along ``dims[i]`` in
        rank order; the inverse of ``block``."""
        flat = self.all_gather(torch.cat([b.reshape(-1) for b in blocks]),
                               axis=axis)
        ranks = flat.view(self.shape[axis], -1)
        out, off = [], 0
        for dim, b in zip(dims, blocks):
            n = b.numel()
            out.append(torch.cat([r[off:off + n].view(b.shape)
                                  for r in ranks], dim=dim))
            off += n
        return out

    def all_gather(self, t: torch.Tensor, dim: int = 0,
                   axis: str = "data") -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order, over
        ``axis`` (the data group by default)."""
        group, size = self._groups(axis)
        if not self.distributed or (axis == "model" and size == 1):
            return t
        src = t.detach().contiguous()
        bufs = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(bufs, src, group=group)
        return torch.cat(bufs, dim=dim)

    def ring_shift(self, t: torch.Tensor, axis: str = "data"
                   ) -> torch.Tensor:
        """The previous rank's ``t`` along ``axis``: rank i sends its
        ``t`` to rank i + 1 and receives rank i - 1's (mod the axis's
        size), as ``lax.ppermute`` with the permutation i -> i + 1. One
        ``dist.batch_isend_irecv`` in the axis's group; ``t`` itself on an
        axis of one rank (or without a group). No gradient.

        The transport follows the group's backend: NCCL sends CUDA tensors
        as they are; gloo sends and receives CPU tensors only, so over
        gloo a CUDA tensor goes through the host (copied to the CPU, sent,
        received, copied back to its device). A failed send raises."""
        group, size = self._groups(axis)
        if not self.distributed or size == 1:
            return t
        me = self.data_rank if axis == "data" else self.model_rank
        stage = self.backend == "gloo" and t.device.type != "cpu"
        src = t.detach().to("cpu" if stage else t.device,
                            memory_format=torch.contiguous_format, copy=True)
        buf = torch.empty_like(src)

        def peer(r):
            return dist.get_global_rank(group, r % size)

        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, src, peer(me + 1), group),
            dist.P2POp(dist.irecv, buf, peer(me - 1), group)])
        for w in works:
            w.wait()
        return buf.to(t.device) if stage else buf


class _GlobalSum(torch.autograd.Function):
    """y = the sum of x over the data ranks. Each rank's loss is its share
    of the global loss (the shares add up to it), so the cotangent of the
    global statistic is the sum of the ranks' cotangents: the backward sums
    the incoming gradient over the ranks too. The gradient all-reduce of
    the step then adds the ranks' parameter gradients once."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g), None


def global_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Differentiable sum of ``x`` over the mesh's data ranks (``x`` itself
    with no mesh or no group)."""
    if mesh is None or not mesh.distributed:
        return x
    return _GlobalSum.apply(x, mesh)


def sum_gradients(grads: List[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Each gradient replaced, in place, by its sum over the data ranks (one
    collective). Each rank's loss is its share of the global loss, so the
    sums are the global loss's gradients. A tensor-parallel shard's
    gradient is summed over the ranks that hold the same shard, and a
    replicated leaf's is already the same on every model rank."""
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


def make_mesh(data: Optional[int] = None, model: int = 1, group=None,
              timeout: Optional[float] = None) -> Mesh:
    """A ``(data, model)`` mesh over ``group`` (a ``torch.distributed``
    process group; ``dist.group.WORLD`` for the default one). ``data``
    None: the group's size over ``model``. Without a group only the 1 x 1
    mesh (one process) is possible.

    ``model`` > 1 builds the grid's sub-groups with ``dist.new_group``: the
    M data groups (ranks m, M + m, 2M + m, ...), then the D model groups
    (ranks dM .. dM + M - 1). Every process of the default group must call
    ``make_mesh`` with the same arguments at the same point, as
    ``new_group`` requires. ``timeout`` (seconds): the sub-groups'
    collective timeout (torch's default when None)."""
    if model < 1 or (data is not None and data < 1):
        raise ValueError(f"mesh {data}x{model}: the degrees must be >= 1")
    if group is None:
        if (data or 1) != 1 or model != 1:
            raise ValueError(f"a mesh of data={data} model={model} needs a "
                             f"process group of that many ranks (init_group_"
                             f"from_env under torchrun)")
        return Mesh(None, 1, 0, "")
    size = dist.get_world_size(group)
    if data is None:
        data = size // model
    if data * model != size:
        raise ValueError(f"mesh {data}x{model} does not match the process "
                         f"group's {size} ranks")
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group))
    if model == 1:
        return Mesh(group, data, rank, backend)

    def global_ranks(ranks):
        if group is dist.group.WORLD:
            return list(ranks)
        return [dist.get_global_rank(group, r) for r in ranks]

    kw = ({} if timeout is None
          else {"timeout": datetime.timedelta(seconds=timeout)})
    data_group = model_group = None
    for m in range(model):            # the same calls in the same order
        g = dist.new_group(global_ranks(range(m, size, model)), **kw)
        if m == rank % model:
            data_group = g
    for d in range(data):
        g = dist.new_group(global_ranks(range(d * model, (d + 1) * model)),
                           **kw)
        if d == rank // model:
            model_group = g
    return Mesh(group, data, rank, backend, model, data_group, model_group)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array lies over the mesh: ``spec`` ``("data",)`` splits its
    leading axis over the data ranks, ``()`` replicates it."""
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
class TreeSharding:
    """``MeshRules.tree_sharding``'s result: the mesh, each state entry's
    spec by name (``params``: parameters and buffers) and each entry's
    optimizer-moment spec (``moments``). What ``make_train_step(
    state_sharding=)``, ``make_eval_step(variables_sharding=)`` and
    ``evaluate_model(variables_sharding=)`` take."""
    mesh: Mesh
    params: Dict[str, Tuple]
    moments: Dict[str, Tuple]

    def model_axis(self, name: str) -> Optional[int]:
        """The torch axis of ``name`` split over 'model', or None."""
        spec = self.params.get(name, ())
        return spec.index("model") if "model" in spec else None


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """The JAX package's partition rules, on the port's leaves: ``path`` is
    a parameter's name split at the dots, ``leaf`` the whole (unsharded)
    tensor in torch's layout. A spec is a tuple with one entry per axis
    ("data", "model" or None) and the empty tuple for a replicated leaf,
    as a PartitionSpec."""
    mesh: Mesh
    shard_model_channels: bool = False  # TP: conv out-channels on 'model'
    shard_opt_state_data: bool = False  # ZeRO-1: optimizer moments on 'data'

    def param_spec(self, path, leaf) -> Tuple:
        """A 4-D floating leaf split on its output axis over 'model' when
        the model degree divides it: torch axis 0 of a Conv2d weight (JAX
        axis 3, HWIO), torch axis 1 of a transposed conv's (JAX axis 2,
        HWOI), which the JAX rule finds by 'wt' (or 'up') in its path, as
        here. Everything else is replicated."""
        model_size = self.mesh.shape["model"]
        if (not self.shard_model_channels or leaf.dim() != 4
                or not leaf.is_floating_point()):
            return ()
        out_axis = _JAX_TO_TORCH[2 if ("wt" in path or "up" in path) else 3]
        if leaf.shape[out_axis] % model_size:
            return ()
        spec = [None] * 4
        spec[out_axis] = "model"
        return tuple(spec)

    def opt_state_spec(self, path, leaf) -> Tuple:
        """ZeRO-1 on top of the channel rule: a floating moment on 'data'
        along its largest dimension that is not already on 'model' and
        that the data degree divides. The dimensions are ranked in the JAX
        layout, so a tie goes where the JAX rule puts it (the first
        largest JAX axis)."""
        base = self.param_spec(path, leaf)
        data_size = self.mesh.shape["data"]
        ndim = leaf.dim()
        if (not self.shard_opt_state_data or data_size <= 1 or ndim == 0
                or not leaf.is_floating_point()):
            return base
        spec = list(base) + [None] * (ndim - len(base))
        order = _JAX_TO_TORCH if ndim == 4 else tuple(range(ndim))
        free = [a for a in order
                if spec[a] is None and leaf.shape[a] % data_size == 0]
        if not free:
            return base
        spec[max(free, key=lambda a: leaf.shape[a])] = "data"  # first tie
        return tuple(spec)

    def zero1_axis(self, name: str, leaf) -> Optional[int]:
        """The torch axis ``opt_state_spec`` splits over 'data', or None."""
        spec = self.opt_state_spec(tuple(name.split(".")), leaf)
        return spec.index("data") if "data" in spec else None

    def tree_sharding(self, state: Mapping[str, torch.Tensor]
                      ) -> TreeSharding:
        """The specs of a whole model state (``model.state_dict()`` of the
        unsharded model, or its named parameters): the channel rule for
        every entry (parameters and BatchNorm statistics alike, as the JAX
        rule treats ``params`` and ``stats``), and the moment rule (ZeRO-1
        on top) for the optimizer state of each, as under ``opt_state``."""
        params, moments = {}, {}
        for name, leaf in state.items():
            path = tuple(name.split("."))
            params[name] = self.param_spec(path, leaf)
            moments[name] = self.opt_state_spec(path, leaf)
        return TreeSharding(self.mesh, params, moments)


def resolve_sharding(sharding, mesh, arg: str):
    """A step's ``state_sharding``/``variables_sharding`` with its
    ``mesh``: (mesh, sharding). The sharding must be ``tree_sharding``'s
    result (else TypeError) on the same mesh as ``mesh`` when both are
    given; its mesh stands in for a missing ``mesh``."""
    if sharding is None:
        return mesh, None
    if not isinstance(sharding, TreeSharding):
        raise TypeError(f"{arg} must be MeshRules.tree_sharding's result "
                        f"(a parallel.TreeSharding), got "
                        f"{type(sharding).__name__}")
    if mesh is None:
        return sharding.mesh, sharding
    if mesh is not sharding.mesh:
        raise ValueError(f"{arg} was made for another mesh than mesh=")
    return mesh, sharding


# ---------------------------------------------------------------------------
# The group of a torchrun launch
# ---------------------------------------------------------------------------

def init_group_from_env(device=None, data: Optional[int] = None,
                        model: int = 1):
    """The default process group from torchrun's environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL for the card,
    where LOCAL_RANK picks the card, gloo for the CPU; an explicit
    timeout. ``data`` and ``model``: the mesh the caller expects, whose
    size ``data * model`` must be WORLD_SIZE. Returns (mesh, device)."""
    n = (data or 1) * model
    if "WORLD_SIZE" not in os.environ:
        raise ValueError(
            f"a parallel run (data={data}, model={model}) needs one process "
            f"a rank: launch it under torchrun (torchrun --nproc-per-node "
            f"{n} -m unet_convlstm_tpu_torch ...)")
    world = int(os.environ["WORLD_SIZE"])
    if data is not None and world != n:
        raise ValueError(f"WORLD_SIZE={world} but the run asks for "
                         f"data={data} x model={model} ranks: launch "
                         f"mesh_data x mesh_model processes")
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
    return make_mesh(data, model, group=dist.group.WORLD,
                     timeout=GROUP_TIMEOUT_S), dev

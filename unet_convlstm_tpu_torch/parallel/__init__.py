"""Parallelism (counterpart of unet_convlstm_tpu/parallel/): a
``torch.distributed`` process group seen as a ``(data, model)`` mesh, the
batch sharded over ``data``, the JAX package's partition rules, and the
collectives a data-parallel step calls. Tensor parallelism (``model`` > 1)
is not ported yet (ROADMAP.md, queue A item 7b)."""

from .mesh import (  # noqa: F401
    make_mesh, batch_sharding, replicated_sharding, shard_batch_spec,
    MeshRules,
)

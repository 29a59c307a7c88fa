"""Parallelism (counterpart of unet_convlstm_tpu/parallel/): a
``torch.distributed`` process group seen as a ``(data, model)`` mesh, the
batch sharded over ``data``, conv kernels split by output channel over
``model`` (``tensor.py``), the JAX package's partition rules, and the
collectives a parallel step calls."""

from .mesh import (  # noqa: F401
    make_mesh, batch_sharding, replicated_sharding, shard_batch_spec,
    MeshRules, TreeSharding,
)
from .tensor import (  # noqa: F401
    shard_model, full_state_dict, load_full_state_dict,
)

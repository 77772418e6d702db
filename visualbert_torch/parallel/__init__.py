"""Multi-GPU training: ``torch.distributed`` bring-up (``distributed``) and
the (data, model) mesh over its process groups (``mesh``); counterpart of
``visualbert_tpu/parallel``."""

from visualbert_torch.parallel.mesh import (
    LOGICAL_AXIS_RULES,
    Mesh,
    create_mesh,
    gather_params,
    shard_module,
    shard_params,
)

__all__ = ["LOGICAL_AXIS_RULES", "Mesh", "create_mesh", "gather_params", "shard_module", "shard_params"]

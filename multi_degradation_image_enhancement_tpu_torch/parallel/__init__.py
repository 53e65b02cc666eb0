"""The port's scale-out layer: a named process mesh (``mesh``), the
multi-process bootstrap (``distributed``) and the differentiable collectives
the sharded steps insert (``collectives``)."""

from multi_degradation_image_enhancement_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    SPATIAL_AXIS,
    batch_sharding,
    batch_spec,
    create_mesh,
    replicate,
    replicated,
    shard_batch,
    shard_eval_step,
    shard_train_step,
)

__all__ = [
    "DATA_AXIS",
    "EXPERT_AXIS",
    "SPATIAL_AXIS",
    "batch_sharding",
    "batch_spec",
    "create_mesh",
    "replicate",
    "replicated",
    "shard_batch",
    "shard_eval_step",
    "shard_train_step",
]

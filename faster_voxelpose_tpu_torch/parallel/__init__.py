"""Scale-out of the port on torch.distributed (counterpart of
`faster_voxelpose_tpu/parallel/`): data-parallel train and eval steps,
the view-sharded forward and the two-stage streaming pipeline."""

from .mesh import (
    DataParallelTrainer,
    Mesh,
    PipelinedStream,
    Sharding,
    batch_sharding,
    make_dp_eval_step,
    make_dp_train_step,
    make_mesh,
    make_view_sharded_forward,
    replicated,
    shard_batch,
)

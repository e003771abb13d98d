"""Data-parallel training over ``torch.distributed`` (the port's
``raft_stereo_tpu/parallel``; the sequence-parallel ring is ROADMAP A13)."""

from raft_stereo_tpu_torch.parallel.data_parallel import (
    dryrun_flagship_scaled,
    dryrun_flagship_shape,
    dryrun_train_step,
    make_pjit_train_step,
    make_shardmap_train_step,
)
from raft_stereo_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SEQ_AXIS,
    Mesh,
    batch_sharding,
    batch_specs,
    make_mesh,
    replicated,
    shard_batch,
)

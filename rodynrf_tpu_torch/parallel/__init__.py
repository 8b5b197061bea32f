"""Data parallelism over rays and the sample-sharded compositor on
torch.distributed (port of rodynrf_tpu/parallel/; mesh.py states the
gradient rule)."""

from .mesh import (
    batch_sharded,
    grid_sharded,
    make_mesh,
    replicated,
    shard_batch_indices,
    shard_train_inputs,
)
from .multihost import global_batch_from_local, global_mesh, process_span
from .sample_shard import (
    make_2d_mesh,
    make_sample_sharded_raw2outputs,
    shard_compositor_inputs,
)

"""Scale-out over a mesh of shards: the twin of ``embeddinghub_tpu/parallel``."""

from embeddinghub_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    default_mesh,
    process_mesh,
    shard_axis,
)
from embeddinghub_tpu_torch.parallel.sharded_flat import ShardedFlatIndex  # noqa: F401
from embeddinghub_tpu_torch.parallel.sharded_hnsw import ShardedHNSWIndex  # noqa: F401

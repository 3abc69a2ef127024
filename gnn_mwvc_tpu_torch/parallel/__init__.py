"""The multi-device path: meshes, the edge-partitioned graph and the
sharded forward, sticky forward and train step."""

from gnn_mwvc_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    mesh_seconds_per_call,
    place_mesh,
    synchronize,
)
from gnn_mwvc_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedGraph,
    gather_scores,
    make_sharded_forward,
    make_sharded_train_step,
    make_sticky_sharded_forward,
    partition_device_graph,
)

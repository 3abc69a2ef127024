from gnn_mwvc_tpu_torch.core.api import (  # noqa: F401
    CoreLocalSearch,
    CoreSolver,
    Snapshot,
    cluster_order,
    confidence_order_native,
)

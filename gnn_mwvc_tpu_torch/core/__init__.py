from gnn_mwvc_tpu_torch.core.api import (  # noqa: F401
    BASELINE_IDS,
    CoreLocalSearch,
    CoreSolver,
    Snapshot,
    approx_cover,
    baseline_solve,
    bfs_order,
    cluster_order,
    confidence_order_native,
    greedy_cover,
    improve_cover,
)

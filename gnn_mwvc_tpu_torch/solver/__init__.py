from gnn_mwvc_tpu_torch.solver.pipeline import (  # noqa: F401
    GnnScorer,
    SolveResult,
    solve,
)
from gnn_mwvc_tpu_torch.solver.sharded_score import (  # noqa: F401
    ShardedGnnScorer,
)

from gnn_mwvc_tpu_torch.utils.metrics import (  # noqa: F401
    PhaseTimer,
    SolveMetrics,
    trace_span,
)

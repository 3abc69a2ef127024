from gnn_mwvc_tpu_torch.core import baseline_solve  # noqa: F401

"""Study and protocol tools of the port, each ``python -m
gnn_mwvc_tpu_torch.tools.<name> --help``; every one runs on the card by
default and takes ``--device cpu``."""

"""gnn_mwvc_tpu_torch: the GNN-guided MWVC solver in PyTorch for one NVIDIA
H100, beside the JAX package ``gnn_mwvc_tpu`` (the reference it is tested
against).  The host core (reductions, peeling, local search, unfold) is the
same C++ library; the device side (GNN forward, region solver) is PyTorch
plus hand-written CUDA kernels (``csrc/``).  This package never imports jax.
"""

__version__ = "0.1.0"

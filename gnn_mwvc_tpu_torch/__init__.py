"""gnn_mwvc_tpu_torch: the GNN-guided MWVC solver in PyTorch for one NVIDIA
H100, beside the JAX package ``gnn_mwvc_tpu`` (the reference it is tested
against).  The host core (reductions, peeling, local search, unfold) is the
port's own copy of the C++ sources (``core/src/``, built by g++ at first
use; ``bash gnn_mwvc_tpu_torch/core/sanitize.sh asan`` checks it under a
sanitizer), and the published weights ship in ``models/weights/``.  The
device side (GNN forward, region solver) is PyTorch plus hand-written CUDA
kernels (``csrc/``).  This package never imports jax and reads no file of
the JAX package.
"""

__version__ = "0.1.0"

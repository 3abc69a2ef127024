// Readable CUDA error strings for the Python wrappers' exceptions.

#include <cuda_runtime.h>

extern "C" const char* gnn_mwvc_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

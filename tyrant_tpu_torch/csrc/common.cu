// Shared C entry points of the tyrant_tpu_torch kernel library.
#include <cuda_runtime.h>

extern "C" const char* tyrant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

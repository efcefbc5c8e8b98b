// Error reporting for the ctypes-bound entry points.
#include "common.cuh"

extern "C" const char* lam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

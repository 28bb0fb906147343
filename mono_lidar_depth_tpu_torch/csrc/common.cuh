// Shared by every kernel source: each is built into a library of its
// own, and each library exports the CUDA error text for the codes its
// entry points return.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* mld_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

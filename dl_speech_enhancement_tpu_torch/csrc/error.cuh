// The C entry every kernel library exports beside its kernels: the text of
// an error code that an entry point returned (ops/_cuda.py::check).
#pragma once

#include <cuda_runtime.h>

extern "C" const char* dse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

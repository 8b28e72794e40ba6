// Shared by every kernel library: each .cu compiles on its own into a
// shared library with a plain C interface, loaded from Python with ctypes.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int MB = 16;  // macroblock side, as in repro/codec/motion.py

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The wrappers raise with this text when an entry returns a nonzero
// cudaError_t.
extern "C" const char* biswift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

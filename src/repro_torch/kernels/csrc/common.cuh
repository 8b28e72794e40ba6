// Shared by every kernel library: each .cu compiles on its own into a
// shared library with a plain C interface, loaded from Python with ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

constexpr int MB = 16;  // macroblock side, as in repro/codec/motion.py

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Storage types: f32, or bf16 with every sum taken in f32.  The
// conversion to bf16 rounds to nearest even, as jnp.astype and
// torch.Tensor.to do.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The wrappers raise with this text when an entry returns a nonzero
// cudaError_t.
extern "C" const char* biswift_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

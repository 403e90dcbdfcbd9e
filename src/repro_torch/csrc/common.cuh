// Shared declarations for the hand-written Hopper kernels of repro_torch.
//
// Every kernel is reached through a plain C launch function that takes
// raw device pointers, sizes, the CUDA device index and the stream of
// the caller (PyTorch's current stream), launches without synchronising,
// and returns cudaGetLastError() so the Python wrapper can raise on a
// refused launch.  The library is built by nvcc for sm_90a and loaded
// with ctypes (repro_torch/kernels/cuda_lib.py).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

namespace repro {

// Load an element of an operand as float.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round a float to T's precision (round to nearest even, as PyTorch's
// casts do) and return it as float again.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Dynamic shared memory above the default 48 KB needs an opt-in per
// kernel; the H100 gives a block at most 227 KB.
constexpr size_t kMaxSmem = 232448;

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro

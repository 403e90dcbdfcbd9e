// Shared declarations and device helpers for the hand-written Hopper
// kernels of repro_torch.
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

// Asynchronous copies into shared memory and ldmatrix (K2, K4, K5).  A copy
// of `bytes` below its size zero-fills the rest (0: no read, all zeros).
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The same four 8 x 8 matrices, each transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// ---- bf16 tensor-core attention (K4, K5) -----------------------------------

using bf16 = __nv_bfloat16;

// d += a @ b on one m16n8k16 tile: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Start the copy of one chunk of 8 bf16 into shared memory at d: the
// first `valid` from s, the rest zero (`any`: a valid address for the
// copies that read nothing; valid 0 reads nothing).  vec: 16 (16-byte
// cp.async), 4 (4-byte cp.async) or 2 (element loads, synchronous).
__device__ __forceinline__ void copy_chunk(bf16* d, const bf16* s, const bf16* any, int valid,
                                           int vec) {
  if (vec == 16) {
    cp16(d, valid ? s : any, 2 * valid);
  } else if (vec == 4) {
#pragma unroll
    for (int e = 0; e < 8; e += 2) cp4(d + e, e < valid ? s + e : any, e < valid ? 4 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) d[e] = e < valid ? s[e] : __float2bfloat16(0.0f);
  }
}

}  // namespace repro

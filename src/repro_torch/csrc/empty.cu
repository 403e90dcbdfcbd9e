// An empty kernel: the launch floor.
//
// It replaces no TPU kernel.  A kernel whose work is smaller than its
// launch (K1 at the DSE's shapes) cannot take less time than this one, so
// chip_smoke.py times it by CUDA graph replay beside K1.
#include "common.cuh"

namespace {

__global__ void empty_kernel() {}

}  // namespace

REPRO_EXPORT int empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

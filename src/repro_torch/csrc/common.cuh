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
#include <cuda_runtime.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

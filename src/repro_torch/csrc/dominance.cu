// K1: constrained (Deb) Pareto dominance matrix, batched over scenarios.
//
// Replaces repro/kernels/pareto_rank.py:dominance_matrix_pallas.
//
//   D[s, i, j] = (feas_i & feas_j & pareto_dom(F[s,i], F[s,j])) | (v_i < v_j)
//
// with feas = (v <= 0), NaN objectives read as +inf, and v = 0 when the
// caller passes no violation.  F is (S, P, M) float32, v (S, P) float32,
// D (S, P, P) uint8 holding 0/1 (viewed as bool by the wrapper).
//
// What bounds it on an H100: nothing but the launch.  NSGA-II calls it
// every generation at P <= 256 and M = 4: 16 scenarios x 256 x 256 pairs
// is ~1 M threads reading 64 KiB and writing 1 MiB, less work than the
// launch itself costs (PERF.md has the measured times).  The design is
// the simplest correct one: one thread per (s, i, j), a loop over M,
// the ragged edges masked in the kernel so nothing is padded (the TPU
// kernel padded P to 128 with +inf rows).  The objective rows are tiny
// and stay in L1.  A CUDA graph over the generation loop, not a faster
// kernel, is what would cut its cost.
#include <math.h>

#include "common.cuh"

namespace {

__global__ void dominance_kernel(const float* __restrict__ F,
                                 const float* __restrict__ v,
                                 uint8_t* __restrict__ out, int P, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const long long s = blockIdx.z;
  if (i >= P || j >= P) return;

  const float* fi = F + (s * P + i) * M;
  const float* fj = F + (s * P + j) * M;
  bool le = true;
  bool lt = false;
  for (int m = 0; m < M; ++m) {
    float a = fi[m];
    float b = fj[m];
    if (isnan(a)) a = INFINITY;
    if (isnan(b)) b = INFINITY;
    le = le && (a <= b);
    lt = lt || (a < b);
  }
  float vi = 0.0f;
  float vj = 0.0f;
  if (v != nullptr) {
    vi = v[s * P + i];
    vj = v[s * P + j];
  }
  const bool d = (vi <= 0.0f && vj <= 0.0f && le && lt) || (vi < vj);
  out[(s * P + i) * P + j] = d ? 1 : 0;
}

}  // namespace

REPRO_EXPORT int dominance_launch(const float* F, const float* v, uint8_t* out,
                                  int S, int P, int M, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S == 0 || P == 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((P + 31) / 32, (P + 7) / 8, S);
  dominance_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(F, v, out, P, M);
  return (int)cudaGetLastError();
}

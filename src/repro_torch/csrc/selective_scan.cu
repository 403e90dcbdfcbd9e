// K7: the Mamba-1 selective scan, forward.
//
// Replaces repro/kernels/selective_scan.py:selective_scan_pallas.
//
//   u, dt (B, S, D); Bc, Cc (B, S, N); A (D, N); Dskip (D,); h0 (B, D, N)
//   or null (zeros); all float32.  Per channel (b, d), for t = 0..S-1:
//     h   = exp(dt[b,t,d] * A[d]) * h + (dt[b,t,d] * u[b,t,d]) * Bc[b,t]
//     y[b,t,d] = h . Cc[b,t] + Dskip[d] * u[b,t,d]
//   h_last[b, d] = h after step S-1.
//
// What bounds it on an H100: the exponentials.  At the serve's prefill
// shape (B 4, S 512, D 8192, N 16) it moves ~204 MB (u, dt and y, plus
// B, C, A and h), 0.061 ms at 3.35 TB/s, and takes B*S*D*N = 268 M
// exp's on the special-function units, 0.064 ms at 16 per clock per SM.
//
// Design: the TPU kernel walked S as a sequential grid axis with the
// state in VMEM scratch across grid steps.  Here the walk over S is a
// loop inside the CTA: one thread per channel (b, d) keeps its N-wide
// state and its row of A in registers (N a template parameter: 8 or
// 16), so nothing of the state touches memory until h_last.  A CTA holds
// 128 channels of one batch row.  B_t and C_t, which every channel of
// the row shares, are staged in shared memory a chunk of TS steps at a
// time (reads are broadcasts).  u and dt are read along D, so a warp's
// loads are coalesced; each thread loads the next chunk's u and dt into
// registers before it computes the current one, so the loads overlap
// the arithmetic.  Padding is not the kernel's work: the caller zeroes
// dt at padded steps, where exp(0) = 1 and dt * u = 0 carry h unchanged.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;   // channels per CTA
constexpr int TS = 16;         // timesteps per staged chunk

template <int N>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const float* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ Bc, const float* __restrict__ Cc,
                      const float* __restrict__ A, const float* __restrict__ Dskip,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int D) {
  __shared__ float b_s[TS * N];
  __shared__ float c_s[TS * N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < D;
  const long long row = (long long)b * S;          // (b, t) -> row + t
  const long long state = ((long long)b * D + d) * N;

  float a[N], h[N];
  float dskip = 0.0f;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? A[(long long)d * N + n] : 0.0f;
    h[n] = (live && h0 != nullptr) ? h0[state + n] : 0.0f;
  }
  if (live) dskip = Dskip[d];

  float u_c[TS], dt_c[TS];
#pragma unroll
  for (int j = 0; j < TS; ++j) {
    const bool ok = live && j < S;
    u_c[j] = ok ? u[(row + j) * D + d] : 0.0f;
    dt_c[j] = ok ? dt[(row + j) * D + d] : 0.0f;
  }

  for (int t0 = 0; t0 < S; t0 += TS) {
    const int n_t = min(TS, S - t0);               // the same for every thread
    __syncthreads();                               // the last chunk's reads are done
    for (int i = threadIdx.x; i < n_t * N; i += THREADS) {
      b_s[i] = Bc[(row + t0) * N + i];
      c_s[i] = Cc[(row + t0) * N + i];
    }
    float u_n[TS], dt_n[TS];
#pragma unroll
    for (int j = 0; j < TS; ++j) {
      const int t = t0 + TS + j;
      const bool ok = live && t < S;
      u_n[j] = ok ? u[(row + t) * D + d] : 0.0f;
      dt_n[j] = ok ? dt[(row + t) * D + d] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < TS; ++j) {
      if (j < n_t) {
        const float du = dt_c[j] * u_c[j];
        float acc = 0.0f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          h[n] = expf(dt_c[j] * a[n]) * h[n] + du * b_s[j * N + n];
          acc = fmaf(h[n], c_s[j * N + n], acc);
        }
        if (live) y[(row + t0 + j) * D + d] = acc + dskip * u_c[j];
      }
    }
#pragma unroll
    for (int j = 0; j < TS; ++j) {
      u_c[j] = u_n[j];
      dt_c[j] = dt_n[j];
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[state + n] = h[n];
  }
}

template <int N>
int launch(const float* u, const float* dt, const float* Bc, const float* Cc,
           const float* A, const float* Dskip, const float* h0, float* y, float* h_last,
           int B, int S, int D, cudaStream_t stream) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  selective_scan_kernel<N><<<grid, THREADS, 0, stream>>>(u, dt, Bc, Cc, A, Dskip, h0, y,
                                                         h_last, S, D);
  return (int)cudaGetLastError();
}

}  // namespace

REPRO_EXPORT int selective_scan_launch(const float* u, const float* dt, const float* Bc,
                                       const float* Cc, const float* A, const float* Dskip,
                                       const float* h0, float* y, float* h_last, int B,
                                       int S, int D, int N, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || D == 0) return 0;
  if (B > 65535 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (N == 8) return launch<8>(u, dt, Bc, Cc, A, Dskip, h0, y, h_last, B, S, D, s);
  if (N == 16) return launch<16>(u, dt, Bc, Cc, A, Dskip, h0, y, h_last, B, S, D, s);
  return (int)cudaErrorInvalidValue;
}

// K7: the Mamba-1 selective scan, forward.
//
// Replaces repro/kernels/selective_scan.py:selective_scan_pallas.
//
//   u, dt (B, S, D); Bc, Cc (B, S, N); A (D, N); Dskip (D,); h0 (B, D, N)
//   or null (zeros).  u is float32 or bf16 (widened in registers, which
//   is exact); everything else is float32.  Per channel (b, d), for
//   t = 0..S-1:
//     h   = exp(dt[b,t,d] * A[d]) * h + (dt[b,t,d] * u[b,t,d]) * Bc[b,t]
//     y[b,t,d] = h . Cc[b,t] + Dskip[d] * u[b,t,d]
//   h_last[b, d] = h after step S-1.
//
// What bounds it on an H100: the exponentials, with the issue slots close
// behind.  At the serve's prefill shape (B 4, S 512, D 8192, N 16; u
// bf16) it moves ~168 MB (u, dt and y, plus B, C, A and h), 0.050 ms at
// 3.35 TB/s, and takes B*S*D*N = 268 M exp's on the special-function
// units, 0.064 ms at 16 per clock per SM; every (t, n) also takes four
// FP32 instructions (dt * a2, du * B, the h update, the y term), which
// no layout removes.  Measured, the kernel runs at ~60% of the exps'
// time and neither they nor the bytes bind it (PERF.md, section 7).
//
// Design.  The TPU kernel walked S as a sequential grid axis with the
// state in VMEM scratch.  Here the walk over S is a loop inside the CTA,
// and S is not split across CTAs (a chunked scan would take a second
// exp per (t, n) for the carried state, and the exps are what bind).
//   - States split across lanes: each lane holds SPL = 8 of a channel's
//     N states (2 adjacent lanes a channel at N = 16, 1 at N = 8) with
//     their h and a2 = A * log2(e) in registers.  A CTA of 128 threads
//     holds 64 channels (N = 16) of one batch row: at the serve's shape a
//     grid of (128, 4) = 512 CTAs, 2048 warps, all resident at 4 CTAs an
//     SM.  (4 states a lane doubles the warps but costs more instructions
//     an exp: the per-step loads, dt * u, D * u and the fold are shared
//     by fewer states; on the card it ran slower.)
//   - exp2 on the SFUs: exp(dt A) = ex2.approx.ftz(dt * a2), one FMUL and
//     one MUFU.EX2.  ex2(+-0) is exactly 1, so a step with dt = 0 (the
//     caller's padding: dt * u = 0) carries h bit for bit.
//   - y: each lane's partial of h . C_t (the first lane's starting from
//     D * u), then a reduce-scatter over the channel's lanes by xor
//     shuffles: over a group of G = 2 * LANES steps each lane keeps the
//     whole sum of one step per lane set, so a step costs one shuffle and
//     one add per lane at N = 16, and every lane stores.  A group's loads
//     come before its stores, so its steps overlap.
//   - A two-stage cp.async ring: each chunk of TS steps of the CTA's u
//     (in its own type), dt, B_t and C_t lands in shared memory while the
//     previous chunk is computed; 16-byte copies, 4-byte or element
//     copies where rows are not 16-byte aligned, zero-fill past D and,
//     up to a whole group, past S.  A lane reads its B_t and C_t values
//     as float4s; u and dt are broadcasts to a channel's lanes.  y is
//     staged per chunk in shared memory and stored 16 bytes a thread.
#include <math.h>

#include "common.cuh"

namespace {

using repro::bf16;

constexpr int THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct Tile {
  static constexpr int SPL = 8 < N ? 8 : N;     // states a lane
  static constexpr int LANES = N / SPL;         // lanes a channel
  static constexpr int CH = THREADS / LANES;    // channels a CTA
  static constexpr int TS = 2048 / CH;          // steps a staged chunk
  static constexpr int G = 2 * LANES;           // steps a group (a multiple of LANES)
  static constexpr int MIN_CTAS = 4;            // CTAs an SM (launch bounds)
  // Row stride of the y tile: lane l of a channel writes row l of a
  // group, 32 / LANES banks apart, so a warp's stores are conflict-free.
  static constexpr int YS = CH + (LANES > 1 ? 32 / LANES : 0);
};

// Per stage: dt_s [TS][CH], b_s [TS][N], c_s [TS][N] (f32), u_s [TS][CH] (U).
template <typename U, int N>
__host__ __device__ constexpr int stage_bytes() {
  using T = Tile<N>;
  return T::TS * T::CH * 4 + 2 * T::TS * N * 4 + T::TS * T::CH * (int)sizeof(U);
}

// Two stages, then the y tile [TS][YS].
template <typename U, int N>
constexpr size_t smem_bytes() {
  return 2 * (size_t)stage_bytes<U, N>() + (size_t)Tile<N>::TS * Tile<N>::YS * 4;
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ bf16 zero<bf16>() { return __float2bfloat16(0.0f); }

// Start the copy of one 16-byte chunk of T into shared memory at dst: the
// first `valid` elements from src, the rest zero (`any`: a valid address
// for the copies that read nothing).  vec: 16 (one 16-byte cp.async), 4
// (4-byte cp.async; `valid` then a whole number of 4-byte words) or 0
// (element loads, synchronous).
template <typename T>
__device__ __forceinline__ void stage_chunk(T* dst, const T* src, const T* any, int valid,
                                            int vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec == 16) {
    repro::cp16(dst, valid > 0 ? src : any, valid * (int)sizeof(T));
  } else if (vec == 4) {
    constexpr int P = 4 / sizeof(T);
#pragma unroll
    for (int e = 0; e < E; e += P)
      repro::cp4(dst + e, e < valid ? src + e : any, e < valid ? 4 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = e < valid ? src[e] : zero<T>();
  }
}

// Stage `n_pad` rows (steps) of the CTA's CH channels [d0, d0 + CH) of
// a (.., D) operand starting at row `row0`: rows past `n_t` and channels
// past D are zeros.
template <typename T, int CH>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long row0, int n_t,
                                           int n_pad, int d0, int D, int vec) {
  constexpr int E = 16 / sizeof(T), PER_ROW = CH / E;
  for (int i = threadIdx.x; i < n_pad * PER_ROW; i += THREADS) {
    const int j = i / PER_ROW, e = (i % PER_ROW) * E;
    const int valid = j < n_t ? max(0, min(E, D - (d0 + e))) : 0;
    stage_chunk(dst + j * CH + e, src + (row0 + j) * D + d0 + e, src, valid, vec);
  }
}

// Stage `n_pad` contiguous floats, of which the first `n` are read and
// the rest zeros (both multiples of 4).
__device__ __forceinline__ void stage_flat(float* dst, const float* src, int n, int n_pad,
                                           int vec) {
  for (int i = threadIdx.x; i < n_pad / 4; i += THREADS)
    stage_chunk(dst + 4 * i, src + 4 * i, src, 4 * i < n ? 4 : 0, vec);
}

// Reduce-scatter over the L lanes of a channel (adjacent lanes, q = the
// lane's index among them): p[s] holds the lane's partial of step s of
// a group of L; returns the sum over the L lanes of step q's partials.
// Each round halves the steps a lane keeps and adds its xor partner's
// partial of each (L = 4: (p_0 + p_2) + (p_1 + p_3), lanes numbered).
template <int L>
__device__ __forceinline__ float reduce_scatter(float* p, int q) {
#pragma unroll
  for (int m = L / 2; m >= 1; m /= 2) {
    const bool hi = q & m;
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const float send = hi ? p[i] : p[m + i];
      const float keep = hi ? p[m + i] : p[i];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return p[0];
}

template <typename U, int N>
__global__ void __launch_bounds__(THREADS, Tile<N>::MIN_CTAS)
selective_scan_kernel(const U* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ Bc, const float* __restrict__ Cc,
                      const float* __restrict__ A, const float* __restrict__ Dskip,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ h_last, int S, int D, int vec_u, int vec_dt,
                      int vec_bc, int vec_y) {
  using T = Tile<N>;
  constexpr int CH = T::CH, TS = T::TS, LANES = T::LANES, SPL = T::SPL, G = T::G, YS = T::YS;
  static_assert(TS % G == 0 && G % LANES == 0, "a chunk holds whole groups of whole lane sets");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STAGE = stage_bytes<U, N>();
  float* y_s = reinterpret_cast<float*>(smem + 2 * STAGE);
  auto dt_s = [&](int s) { return reinterpret_cast<float*>(smem + s * STAGE); };
  auto b_s = [&](int s) { return dt_s(s) + TS * CH; };
  auto c_s = [&](int s) { return b_s(s) + TS * N; };
  auto u_s = [&](int s) { return reinterpret_cast<U*>(c_s(s) + TS * N); };

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int c = threadIdx.x / LANES, q = threadIdx.x % LANES;   // channel, lane of it
  const int d = d0 + c;
  const bool live = d < D;
  const long long row = (long long)b * S;                        // (b, t) -> row + t
  const long long state = ((long long)b * D + d) * N + SPL * q;

  float a2[SPL], h[SPL];
#pragma unroll
  for (int k = 0; k < SPL; ++k) {
    a2[k] = live ? A[(long long)d * N + SPL * q + k] * LOG2E : 0.0f;
    h[k] = (live && h0 != nullptr) ? h0[state + k] : 0.0f;
  }
  // D u joins the first lane's partial of y.
  const float dskip = live && q == 0 ? Dskip[d] : 0.0f;

  // A chunk's rows past S up to a whole group are zeros: dt = u = 0 there
  // leaves h bit for bit, and their y is not stored.
  auto issue = [&](int t0, int s) {
    const int n_t = min(TS, S - t0), n_pad = (n_t + G - 1) / G * G;
    stage_rows<float, CH>(dt_s(s), dt, row + t0, n_t, n_pad, d0, D, vec_dt);
    stage_rows<U, CH>(u_s(s), u, row + t0, n_t, n_pad, d0, D, vec_u);
    stage_flat(b_s(s), Bc + (row + t0) * N, n_t * N, n_pad * N, vec_bc);
    stage_flat(c_s(s), Cc + (row + t0) * N, n_t * N, n_pad * N, vec_bc);
  };

  const int n_chunks = (S + TS - 1) / TS;
  if (n_chunks > 0) issue(0, 0);
  repro::cp_commit();
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * TS, s = k & 1;
    const int n_t = min(TS, S - t0);                             // the same for every thread
    if (k + 1 < n_chunks) issue(t0 + TS, s ^ 1);                 // left by chunk k - 1
    repro::cp_commit();
    repro::cp_wait<1>();
    __syncthreads();                                             // chunk k landed; y_s stored
    const float* dts = dt_s(s);
    const U* us = u_s(s);
    const float* bs = b_s(s);
    const float* cs = c_s(s);
    // Groups of G steps: a group's loads come before its stores, so the
    // compiler can overlap its steps; lane q keeps step q of each lane set.
    for (int j0 = 0; j0 < n_t; j0 += G) {
      float p[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = j0 + g;
        const float dtv = dts[j * CH + c];
        const float uv = repro::to_f32(us[j * CH + c]);
        float bv[SPL], cv[SPL];
#pragma unroll
        for (int k = 0; k < SPL; k += 4) {
          *reinterpret_cast<float4*>(bv + k) =
              *reinterpret_cast<const float4*>(bs + j * N + SPL * q + k);
          *reinterpret_cast<float4*>(cv + k) =
              *reinterpret_cast<const float4*>(cs + j * N + SPL * q + k);
        }
        const float du = dtv * uv;
        float acc = dskip * uv;
#pragma unroll
        for (int k = 0; k < SPL; ++k) {
          h[k] = fmaf(ex2(dtv * a2[k]), h[k], du * bv[k]);
          acc = fmaf(h[k], cv[k], acc);
        }
        p[g] = acc;
      }
#pragma unroll
      for (int r = 0; r < G; r += LANES)
        y_s[(j0 + r + q) * YS + c] = reduce_scatter<LANES>(p + r, q);
    }
    __syncthreads();                                             // y_s complete; stage s read
    for (int i = threadIdx.x; i < n_t * (CH / 4); i += THREADS) {
      const int j = i / (CH / 4), e = (i % (CH / 4)) * 4;
      const float* src = y_s + j * YS + e;
      float* dst = y + (row + t0 + j) * D + d0 + e;
      if (vec_y && d0 + e + 4 <= D) {
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (d0 + e + m < D) dst[m] = src[m];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < SPL; ++k) h_last[state + k] = h[k];
  }
}

// The copy width of a (.., D) operand of T: 16-byte chunks where every
// row starts 16-byte aligned, else 4-byte where rows start 4-byte
// aligned, else element loads.
template <typename T>
int row_vec(const T* p, int D) {
  const size_t row = (size_t)D * sizeof(T);
  if (repro::aligned(p, 16) && row % 16 == 0) return 16;
  if (repro::aligned(p, 4) && row % 4 == 0) return 4;
  return 0;
}

template <typename U, int N>
int launch(const U* u, const float* dt, const float* Bc, const float* Cc, const float* A,
           const float* Dskip, const float* h0, float* y, float* h_last, int B, int S, int D,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<U, N>();
  auto kernel = selective_scan_kernel<U, N>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_bc = repro::aligned(Bc, 16) && repro::aligned(Cc, 16) ? 16
                     : repro::aligned(Bc, 4) && repro::aligned(Cc, 4) ? 4 : 0;
  const int vec_y = repro::aligned(y, 16) && D % 4 == 0;
  const dim3 grid((D + Tile<N>::CH - 1) / Tile<N>::CH, B);
  kernel<<<grid, THREADS, smem, stream>>>(u, dt, Bc, Cc, A, Dskip, h0, y, h_last, S, D,
                                          row_vec(u, D), row_vec(dt, D), vec_bc, vec_y);
  return (int)cudaGetLastError();
}

template <typename U>
int launch_n(const U* u, const float* dt, const float* Bc, const float* Cc, const float* A,
             const float* Dskip, const float* h0, float* y, float* h_last, int B, int S, int D,
             int N, cudaStream_t s) {
  if (N == 8) return launch<U, 8>(u, dt, Bc, Cc, A, Dskip, h0, y, h_last, B, S, D, s);
  if (N == 16) return launch<U, 16>(u, dt, Bc, Cc, A, Dskip, h0, y, h_last, B, S, D, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// u_bf16: u is bf16 (else float32).
REPRO_EXPORT int selective_scan_launch(const void* u, const float* dt, const float* Bc,
                                       const float* Cc, const float* A, const float* Dskip,
                                       const float* h0, float* y, float* h_last, int B,
                                       int S, int D, int N, int u_bf16, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || D == 0) return 0;
  if (B > 65535 || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (u_bf16)
    return launch_n(static_cast<const bf16*>(u), dt, Bc, Cc, A, Dskip, h0, y, h_last, B, S, D,
                    N, s);
  return launch_n(static_cast<const float*>(u), dt, Bc, Cc, A, Dskip, h0, y, h_last, B, S, D, N,
                  s);
}

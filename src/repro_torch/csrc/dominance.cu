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
// What bounds it on an H100: the launch.  NSGA-II calls it every
// generation at P = 96 to 256 and M = 4: 16 x 256 x 256 pairs read 80
// KiB and write 1 MiB, a fraction of a microsecond at the card's rates,
// less than an empty kernel's launch (PERF.md has the measured times).
// So the design keeps one CTA's chain short, and each warp's issue slots
// few: each thing is done once, with no bank conflicts.
//
// Design: a CTA of 4 warps takes one scenario and a tile of rows i.  A
// warp is 8 rows x 4 slots of 16 consecutive j (lane & 7 the row, lane >>
// 3 the slot); its warps lie wj along j and 4 / wj along i (wj = 1, 2 or
// 4, as P needs), so a CTA takes 32 / wj rows (grid S x ceil(P / rows):
// no limit on S beyond the grid's 2^31 CTAs).  It stages the scenario's
// objective rows and violations in shared memory in chunks of jc rows (jc
// a multiple of 16, 32 KB at most), NaN turned into +inf once a row as it
// is staged; a thread issues all its staging loads (and its own row's)
// before it stores any.  A thread keeps F[i] and v_i in registers and
// computes its 16 consecutive j into a 16-bit mask: the 8 lanes of each
// phase of a 16-byte shared-memory load read one address (a broadcast).
// The 16 results go out as one 16-byte store where P % 16 == 0 (16 bytes
// little-endian: j0 + b is bit b), a warp's 8 rows x 64 bytes, or byte by
// byte, stopping at P, where it is not.  M = 4 (the DSE's; F 16-byte
// aligned) stages and reads F[j] as one float4 with F[i] in registers;
// any other M loops over M and reads F[i] from global memory (L1).  Where
// 16 rows of F do not fit a chunk (stage_f = 0: M > 511) only v is
// staged and F[j] is read from global memory too; M = 0 leaves the
// Pareto term false (no objective is less), so D = v_i < v_j.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;               // a CTA
constexpr int kUnroll = 4;              // staging loads a thread issues before its stores

__device__ __forceinline__ float nan_to_inf(float a) { return isnan(a) ? INFINITY : a; }

// Four mask bits -> four bytes of 0/1, bit b into byte b (little-endian).
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n & 1u) | ((n & 2u) << 7) | ((n & 4u) << 14) | ((n & 8u) << 21);
}

// MT: 4, or 0 for any M.  blockDim = (32, wj, kWarps / wj).  stage_f:
// F's rows go through shared memory (always for MT = 4).
template <int MT>
__global__ void __launch_bounds__(kWarps * 32)
    dominance_kernel(const float* __restrict__ F, const float* __restrict__ v,
                     uint8_t* __restrict__ out, int P, int M_rt, int tiles, int jc,
                     int stage_f) {
  const int M = MT == 4 ? 4 : M_rt;
  const int fM = MT == 4 || stage_f ? M : 0;      // staged floats of F a row
  extern __shared__ float4 smem4[];
  float* sF = reinterpret_cast<float*>(smem4);    // [jc][fM]
  float* sv = sF + jc * fM;                        // [jc], 16-byte aligned

  const int WJ = blockDim.y, WR = blockDim.z;
  const int tid = threadIdx.x + 32 * (threadIdx.y + WJ * threadIdx.z);
  const long long s = blockIdx.x / tiles;
  const int tile = blockIdx.x - (int)s * tiles;
  const int i = (tile * WR + threadIdx.z) * 8 + (threadIdx.x & 7);
  const int slot = 4 * threadIdx.y + (threadIdx.x >> 3);     // of 4 * WJ, along j
  const bool live = i < P;
  const float* Fs = F + s * P * M;
  const float* vs = v != nullptr ? v + s * P : nullptr;
  const float* Fi = Fs + (long long)(live ? i : 0) * M;

  float4 fi = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (MT == 4) {
    fi = *reinterpret_cast<const float4*>(Fi);
    fi = make_float4(nan_to_inf(fi.x), nan_to_inf(fi.y), nan_to_inf(fi.z), nan_to_inf(fi.w));
  }
  const float vi = vs != nullptr && live ? vs[i] : 0.0f;
  const bool feas_i = vi <= 0.0f;
  uint8_t* orow = out + (s * P + i) * P;
  const bool packed = (P & 15) == 0;
  const int per_row = MT == 4 ? 1 : fM;           // staged elements of F a row
  const int nthreads = kWarps * 32;

  for (int c0 = 0; c0 < P; c0 += jc) {
    const int rows = min(jc, P - c0);
    const int nf = rows * per_row;                // F's staged elements, then v's rows
    const int n = max(nf, vs != nullptr ? rows : 0);
    for (int k0 = tid; k0 < n; k0 += kUnroll * nthreads) {
      float4 f[kUnroll];
      float fv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * nthreads;
        if (k < nf) {
          if constexpr (MT == 4) f[u] = reinterpret_cast<const float4*>(Fs)[c0 + k];
          else f[u].x = Fs[(long long)c0 * M + k];
        }
        if (vs != nullptr && k < rows) fv[u] = vs[c0 + k];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * nthreads;
        if (k < nf) {
          if constexpr (MT == 4)
            smem4[k] = make_float4(nan_to_inf(f[u].x), nan_to_inf(f[u].y), nan_to_inf(f[u].z),
                                   nan_to_inf(f[u].w));
          else sF[k] = nan_to_inf(f[u].x);
        }
        if (vs != nullptr && k < rows) sv[k] = fv[u];
      }
    }
    __syncthreads();
    if (live) {
      for (int j0 = c0 + 16 * slot; j0 < c0 + rows; j0 += 64 * WJ) {
        const int jl = j0 - c0;          // the 16 rows' first, in the chunk
        uint32_t bits = 0;
        float4 v4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const int j = jl + q;          // past `rows` only in a ragged last 16: not stored
          if (vs != nullptr && (q & 3) == 0) v4 = reinterpret_cast<const float4*>(sv + jl)[q >> 2];
          const float vj = (q & 3) == 0 ? v4.x : (q & 3) == 1 ? v4.y : (q & 3) == 2 ? v4.z : v4.w;
          bool le = true, lt = false;
          if constexpr (MT == 4) {
            const float4 b = smem4[j];
            le = (fi.x <= b.x) & (fi.y <= b.y) & (fi.z <= b.z) & (fi.w <= b.w);
            lt = (fi.x < b.x) | (fi.y < b.y) | (fi.z < b.z) | (fi.w < b.w);
          } else if (fM != 0) {
            for (int m = 0; m < M; ++m) {
              const float a = nan_to_inf(Fi[m]);
              const float b = sF[j * M + m];
              le &= a <= b;
              lt |= a < b;
            }
          } else {
            // Rows past `rows` read the last row's F: in bounds, not stored.
            const float* Fj = Fs + (long long)(c0 + min(j, rows - 1)) * M;
            for (int m = 0; m < M; ++m) {
              const float a = nan_to_inf(Fi[m]);
              const float b = nan_to_inf(Fj[m]);
              le &= a <= b;
              lt |= a < b;
            }
          }
          const bool d = (feas_i & (vj <= 0.0f) & le & lt) | (vi < vj);
          bits |= (uint32_t)d << q;
        }
        if (packed) {
          *reinterpret_cast<uint4*>(orow + j0) =
              make_uint4(spread4(bits), spread4(bits >> 4), spread4(bits >> 8), spread4(bits >> 12));
        } else {
          for (int q = 0; q < 16 && j0 + q < P; ++q) orow[j0 + q] = (uint8_t)((bits >> q) & 1u);
        }
      }
    }
    __syncthreads();                     // the chunk is read before the next overwrites it
  }
}

template <int MT>
cudaError_t launch(const float* F, const float* v, uint8_t* out, int S, int P, int M, int jc,
                   int stage_f, dim3 block, int tiles, size_t smem, cudaStream_t stream) {
  cudaError_t err = repro::allow_smem(dominance_kernel<MT>, smem);
  if (err != cudaSuccess) return err;
  dominance_kernel<MT><<<(unsigned int)((long long)S * tiles), block, smem, stream>>>(
      F, v, out, P, M, tiles, jc, stage_f);
  return cudaGetLastError();
}

}  // namespace

// jc: rows a shared-memory chunk (a multiple of 16); wj: a CTA's warps
// along j (1, 2 or 4), its other 4 / wj warps along i; stage_f: 1 to
// stage F's rows beside v's, 0 to stage v alone (M of any size).
REPRO_EXPORT int dominance_launch(const float* F, const float* v, uint8_t* out, int S, int P,
                                  int M, int jc, int wj, int stage_f, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (S == 0 || P == 0) return 0;
  if (M < 0 || jc < 16 || jc % 16 || (wj != 1 && wj != 2 && wj != 4) || !repro::aligned(out, 16))
    return (int)cudaErrorInvalidValue;
  const int rows = 8 * (kWarps / wj);
  const int tiles = (P + rows - 1) / rows;
  if ((long long)S * tiles >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)jc * ((stage_f ? M : 0) + 1) * sizeof(float);
  const dim3 block(32, wj, kWarps / wj);
  cudaStream_t s = (cudaStream_t)stream;
  // The float4 reads of F need its rows 16-byte aligned (a fresh tensor's are).
  return (int)(M == 4 && stage_f && repro::aligned(F, 16)
                   ? launch<4>(F, v, out, S, P, M, jc, 1, block, tiles, smem, s)
                   : launch<0>(F, v, out, S, P, M, jc, stage_f, block, tiles, smem, s));
}

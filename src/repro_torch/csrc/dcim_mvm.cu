// K2: exact integer matmul through the DCIM bit-serial dataflow.
//
// Replaces repro/kernels/dcim_mvm.py:dcim_mvm_pallas.
//
// x (Bt, M, K) int32 @ w (Bt, K, N) int32 -> (Bt, M, N) int32, one launch
// for the whole batch (the FP pipeline runs its G mantissa groups as the
// batch instead of a vmap of per-group calls).  With U = x mod 2^B_x,
// V = w mod 2^B_w, neg_x = [x < 0], neg_w = [w < 0]:
//
//   x @ w = sum_b sum_s 2^(b + s*k) * (U_s @ V_b)
//           - 2^B_w * U @ neg_w - 2^B_x * neg_x @ V + 2^(B_x+B_w) * neg_x @ neg_w
//
// where U_s = (U >> s*k) & (2^k - 1) are the k-bit input slices the
// macro streams per cycle and V_b = (V >> b) & 1 the weight bit-planes
// it stores.  The kernel keeps that decomposition: for each K-tile it
// forms the slices of U and the planes of V in shared memory, takes each
// (plane, slice) dot, shifts it by b + s*k and accumulates, then adds
// the three sign-correction dots.  All accumulation is uint32, whose
// wrap-around is defined (signed overflow and x << 32 are not): the
// result is exact modulo 2^32, so it equals the TPU kernel's int32
// result bit for bit whatever the summation order, and a shift of 32 or
// more contributes 0, as int32 arithmetic gives it (int16 x int16 reaches
// B_x + B_w = 32).
//
// What bounds it on an H100: the function x @ w is bound by its bytes
// (int32 operands and result) at M = 128, but this version is bound by
// integer operations.  The decomposition does B_w * ceil(B_x / k) + 3
// dots where a plain product does one, so an int8 design with k = 1 does
// 67 times the multiply-adds of x @ w.  This
// first version runs them on CUDA cores (IMAD), 16 per thread per
// k-step from register tiles: a 64 x 64 output tile per 256-thread
// block, 4 x 4 outputs per thread, K-tiles of 16 staged in shared memory
// (slices as uint16, planes as uint8, read back as one 8-byte and one
// 4-byte load per k-step).  Slices lie in [0, 2^k) and planes in {0, 1},
// so a later version can feed the same dots to the int8 tensor cores.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int MAX_BITS = 24;
constexpr int MAX_K = 16;

struct Params {
  int M, K, N;
  int B_x, B_w, k, n_slices;
  int x_signed, w_signed;
};

__host__ __device__ constexpr size_t smem_bytes(int n_slices, int B_w) {
  return (size_t)n_slices * BK * BM * sizeof(uint16_t)  // U slices [s][kk][m]
         + (size_t)B_w * BK * BN                        // V planes [b][kk][n]
         + (size_t)BK * BM * sizeof(uint32_t)           // U        [kk][m]
         + (size_t)BK * BN * sizeof(uint32_t)           // V        [kk][n]
         + (size_t)BK * BM                              // neg_x    [kk][m]
         + (size_t)BK * BN;                             // neg_w    [kk][n]
}

__device__ __forceinline__ uint32_t low_mask(int bits) {
  return bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1u);
}

__global__ void __launch_bounds__(THREADS)
dcim_mvm_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                int32_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Us = reinterpret_cast<uint16_t*>(smem);
  uint8_t* Vp = reinterpret_cast<uint8_t*>(Us + (size_t)p.n_slices * BK * BM);
  uint32_t* Uf = reinterpret_cast<uint32_t*>(Vp + (size_t)p.B_w * BK * BN);
  uint32_t* Vf = Uf + BK * BM;
  uint8_t* nx = reinterpret_cast<uint8_t*>(Vf + BK * BN);
  uint8_t* nw = nx + BK * BM;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const long long bt = blockIdx.z;
  const int32_t* xb = x + bt * p.M * (long long)p.K;
  const int32_t* wb = w + bt * p.K * (long long)p.N;

  const uint32_t mask_x = low_mask(p.B_x);
  const uint32_t mask_w = low_mask(p.B_w);
  const uint32_t mask_k = low_mask(p.k);

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    const int kmax = p.K - k0 < BK ? p.K - k0 : BK;
    // Stage the x tile: U, its k-bit slices, and neg_x (zeros outside).
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      const int32_t v = (gm < p.M && gk < p.K) ? xb[(long long)gm * p.K + gk] : 0;
      const uint32_t u = (uint32_t)v & mask_x;
      Uf[c * BM + r] = u;
      nx[c * BM + r] = v < 0 ? 1 : 0;
      for (int s = 0; s < p.n_slices; ++s)
        Us[((size_t)s * BK + c) * BM + r] = (uint16_t)((u >> (s * p.k)) & mask_k);
    }
    // Stage the w tile: V, its bit-planes, and neg_w.
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      const int32_t v = (gk < p.K && gn < p.N) ? wb[(long long)gk * p.N + gn] : 0;
      const uint32_t u = (uint32_t)v & mask_w;
      Vf[r * BN + c] = u;
      nw[r * BN + c] = v < 0 ? 1 : 0;
      for (int b = 0; b < p.B_w; ++b)
        Vp[((size_t)b * BK + r) * BN + c] = (uint8_t)((u >> b) & 1u);
    }
    __syncthreads();

    // Result fusion over weight bit-planes x shift-accumulate over slices.
    for (int b = 0; b < p.B_w; ++b) {
      const uint8_t* vp = Vp + (size_t)b * BK * BN + tx * TN;
      for (int s = 0; s < p.n_slices; ++s) {
        const int sh = b + s * p.k;
        if (sh >= 32) break;  // contributes 0 modulo 2^32 (and s grows)
        const uint16_t* us = Us + (size_t)s * BK * BM + ty * TM;
        uint32_t part[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] = 0u;
        for (int kk = 0; kk < kmax; ++kk) {
          const ushort4 a = *reinterpret_cast<const ushort4*>(us + kk * BM);
          const uchar4 q = *reinterpret_cast<const uchar4*>(vp + kk * BN);
          const uint32_t av[TM] = {a.x, a.y, a.z, a.w};
          const uint32_t bv[TN] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) part[i][j] += av[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += part[i][j] << sh;
      }
    }

    // Two's-complement sign corrections.
    const bool corr_w = p.w_signed && p.B_w < 32;
    const bool corr_x = p.x_signed && p.B_x < 32;
    const bool corr_xw = p.x_signed && p.w_signed && p.B_x + p.B_w < 32;
    if (corr_w || corr_x || corr_xw) {
      uint32_t c_w[TM][TN], c_x[TM][TN], c_xw[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) c_w[i][j] = c_x[i][j] = c_xw[i][j] = 0u;
      for (int kk = 0; kk < kmax; ++kk) {
        uint32_t uf[TM], nxv[TM], vf[TN], nwv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          uf[i] = Uf[kk * BM + ty * TM + i];
          nxv[i] = nx[kk * BM + ty * TM + i];
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          vf[j] = Vf[kk * BN + tx * TN + j];
          nwv[j] = nw[kk * BN + tx * TN + j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            c_w[i][j] += uf[i] * nwv[j];
            c_x[i][j] += nxv[i] * vf[j];
            c_xw[i][j] += nxv[i] * nwv[j];
          }
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if (corr_w) acc[i][j] -= c_w[i][j] << p.B_w;
          if (corr_x) acc[i][j] -= c_x[i][j] << p.B_x;
          if (corr_xw) acc[i][j] += c_xw[i][j] << (p.B_x + p.B_w);
        }
    }
    __syncthreads();
  }

  int32_t* ob = out + bt * p.M * (long long)p.N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= p.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < p.N) ob[(long long)gm * p.N + gn] = (int32_t)acc[i][j];
    }
  }
}

}  // namespace

REPRO_EXPORT int dcim_mvm_launch(const int32_t* x, const int32_t* w,
                                 int32_t* out, int Bt, int M, int K, int N,
                                 int B_x, int B_w, int k, int x_signed,
                                 int w_signed, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B_x < 1 || B_x > MAX_BITS || B_w < 1 || B_w > MAX_BITS || k < 1 ||
      k > MAX_K)
    return (int)cudaErrorInvalidValue;
  if (Bt == 0 || M == 0 || N == 0) return 0;
  Params p{M, K, N, B_x, B_w, k, (B_x + k - 1) / k, x_signed, w_signed};
  const size_t smem = smem_bytes(p.n_slices, B_w);
  err = cudaFuncSetAttribute(dcim_mvm_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(MAX_BITS, MAX_BITS));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, Bt);
  dcim_mvm_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(x, w, out, p);
  return (int)cudaGetLastError();
}

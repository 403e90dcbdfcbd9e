// K3: floating-point pre-alignment per H-group (paper Fig. 3, §III-A).
//
// Replaces repro/kernels/fp_prealign.py:fp_prealign_pallas.
//
// For each group of H float32 values (a row of the (R, H) input, where
// R = M * G): take the biased exponent e and the signed B_M-bit mantissa
// with its hidden bit (e == 0, i.e. zero and subnormals, gives mantissa
// 0), find the group's max exponent emax, and shift each mantissa right
// (arithmetic) by min(emax - e, 31).  Outputs: mant (R, H) int32 and
// emax (R,) int32.  Bitwise equal to the TPU kernel.
//
// What bounds it on an H100: bytes.  It reads 4 B and writes 4 B per
// element plus 4 B per group, with a handful of integer operations in
// between; on the main path the largest call is the lm_head weight
// (151936 x 2048 float32, ~1.2 GB in, ~1.2 GB out).
//
// Design: a streaming pass that reads each element once.
//
// The vector kernel (H % 4 == 0, x and mant 16-byte aligned, H <= 2048)
// cuts a group into 16-byte chunks of 4 floats.  A group is served by L
// lanes of one warp, L = H / 4 rounded up to a power of two of at most
// 32, so a warp holds 32 / L groups side by side (H = 32: 8 lanes, 4
// groups).  Lane l of a group takes chunks l, l + L, ... (NC of them,
// NC = 1 up to H = 128, H / 128 above), so the L lanes of each load read
// consecutive chunks and a warp's load is contiguous.  A thread takes GPT
// groups (GPT * NC = 4 chunks, 64 bytes, where NC <= 4) and issues all
// their read-once loads (ld.global.cs) before it uses any: 64 bytes in
// flight a thread, against the HBM latency.  The group max is an
// in-register max of each chunk's 4 exponents, then a butterfly of
// __shfl_xor_sync over the L lanes (segments are aligned to L, so it
// never crosses groups); the aligned mantissas go out as 16-byte
// streaming stores (st.global.cs), emax from the group's first lane.  All
// index math is shifts and masks on the compile-time lane counts; row
// offsets are 64-bit.
//
// The scalar kernel takes every other input (H % 4 != 0, storage off
// 16-byte alignment, H > 2048): one element a lane, L lanes a group as
// above but with L = H rounded up to a power of two of at most 32, and a
// second read of each element for the shift.
#include "common.cuh"

namespace {

// One element's aligned mantissa: sign-magnitude B_M-bit mantissa with
// the hidden bit (0 for zero and subnormals) in two's complement, shifted
// right by min(emax - e, 31).
__device__ __forceinline__ int32_t align_one(uint32_t bits, int e_max, int frac_shift) {
  const int e = (int)((bits >> 23) & 0xFFu);
  int32_t m = e > 0 ? (int32_t)(((bits & 0x7FFFFFu) | (1u << 23)) >> frac_shift) : 0;
  if (bits >> 31) m = -m;                    // two's complement
  const int sh = e_max - e < 31 ? e_max - e : 31;
  return m >> sh;                            // arithmetic shift
}

__device__ __forceinline__ int exp_max4(const uint4& v, int e) {
  e = max(e, (int)((v.x >> 23) & 0xFFu));
  e = max(e, (int)((v.y >> 23) & 0xFFu));
  e = max(e, (int)((v.z >> 23) & 0xFFu));
  return max(e, (int)((v.w >> 23) & 0xFFu));
}

constexpr int kThreads = 256;

// GPT groups a thread: enough that a thread has 4 chunks in flight.
template <int NC>
__host__ __device__ constexpr int groups_per_thread() {
  return NC >= 4 ? 1 : 4 / NC;
}

template <int LOG_L, int NC>
__global__ void __launch_bounds__(kThreads)
    fp_prealign_vec_kernel(const float* __restrict__ x, int32_t* __restrict__ mant,
                           int32_t* __restrict__ emax_out, long long R, int H, int B_M) {
  constexpr int L = 1 << LOG_L;
  constexpr int GPW = 32 >> LOG_L;           // groups side by side in a warp
  constexpr int GPT = groups_per_thread<NC>();
  constexpr int WARP_ROWS = GPW * GPT;       // groups a warp takes
  const int lane = threadIdx.x & 31;
  const int sub = lane & (L - 1);            // the lane's place in its group
  const long long warp = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const long long row0 = warp * WARP_ROWS + (lane >> LOG_L);
  const int C = H >> 2;                      // 16-byte chunks a group

  uint4 v[GPT][NC];
#pragma unroll
  for (int g = 0; g < GPT; ++g) {
    const long long row = row0 + g * GPW;
    const uint4* src = reinterpret_cast<const uint4*>(x + row * H);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = k * L + sub;
      v[g][k] = row < R && c < C ? __ldcs(src + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  int e_max[GPT];
#pragma unroll
  for (int g = 0; g < GPT; ++g) {
    e_max[g] = 0;                            // a chunk past the group or R raises no max
#pragma unroll
    for (int k = 0; k < NC; ++k) e_max[g] = exp_max4(v[g][k], e_max[g]);
  }
#pragma unroll
  for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int g = 0; g < GPT; ++g) e_max[g] = max(e_max[g], __shfl_xor_sync(0xffffffffu, e_max[g], off));
  }

  const int frac_shift = 24 - B_M;
#pragma unroll
  for (int g = 0; g < GPT; ++g) {
    const long long row = row0 + g * GPW;
    if (row >= R) break;                     // rows grow with g
    int4* dst = reinterpret_cast<int4*>(mant + row * H);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = k * L + sub;
      if (c < C) {
        const uint4 b = v[g][k];
        __stcs(dst + c, make_int4(align_one(b.x, e_max[g], frac_shift),
                                  align_one(b.y, e_max[g], frac_shift),
                                  align_one(b.z, e_max[g], frac_shift),
                                  align_one(b.w, e_max[g], frac_shift)));
      }
    }
    if (sub == 0) emax_out[row] = e_max[g];
  }
}

template <int LOG_L, int NC>
cudaError_t launch_vec(const float* x, int32_t* mant, int32_t* emax, long long R, int H, int B_M,
                       cudaStream_t stream) {
  constexpr long long rows = (long long)(kThreads / 32) * (32 >> LOG_L) * groups_per_thread<NC>();
  const long long blocks = (R + rows - 1) / rows;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  fp_prealign_vec_kernel<LOG_L, NC><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      x, mant, emax, R, H, B_M);
  return cudaGetLastError();
}

__global__ void fp_prealign_kernel(const float* __restrict__ x, int32_t* __restrict__ mant,
                                   int32_t* __restrict__ emax_out, long long R, int H,
                                   int log_l, int B_M) {
  const int L = 1 << log_l;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = tid >> log_l;
  const int lane = (int)tid & (L - 1);
  const bool active = row < R;
  const uint32_t* bits_row =
      reinterpret_cast<const uint32_t*>(x) + (active ? row * H : 0);

  int e_max = 0;
  if (active) {
    for (int h = lane; h < H; h += L) {
      const int e = (int)((bits_row[h] >> 23) & 0xFFu);
      e_max = e > e_max ? e : e_max;
    }
  }
  // Every lane of the warp takes part in the shuffles (inactive lanes
  // carry 0, which never raises a max).
  for (int off = L >> 1; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(0xffffffffu, e_max, off);
    e_max = o > e_max ? o : e_max;
  }
  if (!active) return;

  const int frac_shift = 24 - B_M;
  int32_t* mant_row = mant + row * H;
  for (int h = lane; h < H; h += L) mant_row[h] = align_one(bits_row[h], e_max, frac_shift);
  if (lane == 0) emax_out[row] = e_max;
}

}  // namespace

// The scalar kernel; log_l = log2 of the lanes a group.
REPRO_EXPORT int fp_prealign_launch(const float* x, int32_t* mant, int32_t* emax, long long R,
                                    int H, int B_M, int log_l, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R == 0 || H == 0) return 0;
  if (log_l < 0 || log_l > 5) return (int)cudaErrorInvalidValue;
  const long long blocks = ((R << log_l) + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  fp_prealign_kernel<<<(unsigned int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, mant, emax, R, H, log_l, B_M);
  return (int)cudaGetLastError();
}

// The vector kernel: L = 2^log_l lanes a group, nc 16-byte chunks a lane
// (nc > 1 only at L = 32), L * nc * 4 >= H.
REPRO_EXPORT int fp_prealign_vec_launch(const float* x, int32_t* mant, int32_t* emax,
                                        long long R, int H, int B_M, int log_l, int nc,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R == 0 || H == 0) return 0;
  if (H % 4 || !repro::aligned(x, 16) || !repro::aligned(mant, 16) || (nc > 1 && log_l != 5) ||
      ((4 * nc) << log_l) < H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (log_l * 100 + nc) {
    case 1: err = launch_vec<0, 1>(x, mant, emax, R, H, B_M, s); break;
    case 101: err = launch_vec<1, 1>(x, mant, emax, R, H, B_M, s); break;
    case 201: err = launch_vec<2, 1>(x, mant, emax, R, H, B_M, s); break;
    case 301: err = launch_vec<3, 1>(x, mant, emax, R, H, B_M, s); break;
    case 401: err = launch_vec<4, 1>(x, mant, emax, R, H, B_M, s); break;
    case 501: err = launch_vec<5, 1>(x, mant, emax, R, H, B_M, s); break;
    case 502: err = launch_vec<5, 2>(x, mant, emax, R, H, B_M, s); break;
    case 504: err = launch_vec<5, 4>(x, mant, emax, R, H, B_M, s); break;
    case 508: err = launch_vec<5, 8>(x, mant, emax, R, H, B_M, s); break;
    case 516: err = launch_vec<5, 16>(x, mant, emax, R, H, B_M, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

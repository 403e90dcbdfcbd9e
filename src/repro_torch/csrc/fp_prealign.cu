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
// Design: a group is served by L lanes of one warp, L the smallest power
// of two >= min(H, 32), so a warp holds 32 / L groups side by side and
// small groups (H = 2..16) do not leave most of a warp idle.  Consecutive
// lanes read consecutive floats, so a warp's loads are coalesced.  For
// H > 32 each lane loops over H / 32 elements.  The group max is a
// butterfly of __shfl_xor_sync over the L lanes (segments are aligned to
// L, so the butterfly never crosses groups).  The second pass re-reads
// the group's elements, which are still in L1.
#include "common.cuh"

namespace {

__global__ void fp_prealign_kernel(const float* __restrict__ x,
                                   int32_t* __restrict__ mant,
                                   int32_t* __restrict__ emax_out,
                                   long long R, int H, int L, int B_M) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = tid / L;
  const int lane = (int)(tid % L);
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

  const int frac_shift = 23 - (B_M - 1);
  int32_t* mant_row = mant + row * H;
  for (int h = lane; h < H; h += L) {
    const uint32_t bits = bits_row[h];
    const int e = (int)((bits >> 23) & 0xFFu);
    const int32_t full = e > 0 ? (int32_t)((bits & 0x7FFFFFu) | (1u << 23)) : 0;
    int32_t m = full >> frac_shift;          // in [2^(B_M-1), 2^B_M) or 0
    if (bits >> 31) m = -m;                  // two's complement
    const int sh = e_max - e < 31 ? e_max - e : 31;
    mant_row[h] = m >> sh;                   // arithmetic shift
  }
  if (lane == 0) emax_out[row] = e_max;
}

}  // namespace

REPRO_EXPORT int fp_prealign_launch(const float* x, int32_t* mant,
                                    int32_t* emax, long long R, int H, int B_M,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (R == 0 || H == 0) return 0;
  int L = 1;
  while (L < H && L < 32) L <<= 1;
  const int threads = 256;
  const long long total = R * L;
  const long long blocks = (total + threads - 1) / threads;
  fp_prealign_kernel<<<(unsigned int)blocks, threads, 0,
                       (cudaStream_t)stream>>>(x, mant, emax, R, H, L, B_M);
  return (int)cudaGetLastError();
}

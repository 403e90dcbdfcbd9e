// K2: exact integer matmul of the DCIM macro, on the int8 tensor cores.
//
// Replaces repro/kernels/dcim_mvm.py:dcim_mvm_pallas.
//
// x (Bt, M, K) int32 @ w (Bt, K, N) int32 -> (Bt, M, N) int32, one launch
// for the whole batch (the FP pipeline runs its G mantissa groups as the
// batch).  The TPU kernel forms B_w weight bit-planes x ceil(B_x / k)
// k-bit input slices plus three two's-complement correction dots; its
// result, for any int32 inputs, is
//
//   X' = (x & (2^B_x - 1)) - (x_signed && x < 0 ? 2^B_x : 0)
//   W' = (w & (2^B_w - 1)) - (w_signed && w < 0 ? 2^B_w : 0)
//   Y  = X' @ W'  mod 2^32, read as int32,
//
// and k does not change it.  The plain version (kernels/ref.py) keeps the
// bit-serial decomposition as the readable specification; this kernel
// computes the same integers by base-256 digits.  X' lies in
// [-2^B_x, 2^B_x - 1], and D balanced digits, each an s8 in [-128, 127],
// reach [-128 R_D, 127 R_D] with R_D = (256^D - 1) / 255.  So X' takes
// the least D_x with 127 R_D >= 2^B_x - 1: 1 digit up to 7 bits, then
// ceil((B_x + 2) / 8), i.e. 2 up to 14 bits, 3 up to 22, 4 for 23 and
// 24.  Then
//
//   X' = sum_{i < D_x} d^x_i 256^i,   d^x_i = b_i - 128,
//
// where b_i are the bytes of X' + 0x80..80 (0x80 in each of the D_x
// low bytes; X' + bias lies in [0, 256^D_x)), so d^x_i is byte i of
// (X' + bias) ^ bias.  The same for W'.
// Then
//
//   Y = sum_{i + j < 4} (d^x_i @ d^w_j) << 8(i + j)   (mod 2^32),
//
// each digit product one mma.sync m16n8k32 .s8.s8 with s32 accumulation;
// products shifted by 32 or more are skipped (0 mod 2^32).  The mma is
// issued WITHOUT .satfinite: a sum may wrap, and only Y mod 2^32 matters
// (int16 codes of -2^15 over K = 64 wrap; a saturating accumulator
// would give another result).  Products: 4 for int8 x int8 and for the
// bf16 path (9 x 9 bits), 8 for 16 x 16 bits, at most 10.  The
// unbalanced form (u8 digits below an s8 or u8 top digit) gives the same
// sum, and there the top digit of an in-range signed 8-bit code is its
// sign extension, so its high products are what the TPU kernel's
// sign-correction dots become; the balanced form puts every product on
// one s8.s8 instruction, where the unbalanced one chooses among four per
// product inside the unrolled tile loop.  In the balanced form an
// in-range signed 8-bit code is its own low digit and its high digit is
// 0: the higher products carry only codes outside the range, which the
// function also defines.
//
// What bounds it on an H100: reading the int32 codes.  At the int8
// lm_head (128 x 2048 x 151936) x, w and y are 1.32 GB, 0.395 ms at
// 3.35 TB/s, where the four digit products are 0.32 TOP, 0.16 ms at the
// int8 peak; at a decode step (M = 2) the work is the weight bytes
// alone.  So the design keeps bytes in flight and spends few
// instructions and registers per element:
//   - the int32 tiles stream into a ring of STAGES shared-memory buffers
//     by 16-byte cp.async (4-byte copies where a row is not 16-byte
//     aligned), the w tile swizzled so its transposing reads are free
//     of bank conflicts;
//   - each staged tile is converted once into digit planes: A digits
//     [digit][m][k], B digits [digit][n][k] (the transposed layout mma's
//     .col B wants; 8-bit values have no ldmatrix.trans, so a 4 x 4 byte
//     transpose in registers does it), rows padded to 48 bytes so
//     ldmatrix reads them without bank conflicts, in two buffers: step
//     t + 1 is converted while the tensor cores take step t;
//   - a k-step whose digits above the lowest are all 0 (in-range 8-bit
//     codes, the DCIM serves' int8 design) takes the low x low product
//     alone: the block ORs the flags its threads raised while converting;
//   - one uint32 accumulator set: the low x low product accumulates in
//     place, every other product is formed alone and added shifted, so
//     no register set per shift is held;
//   - two tiles of 128 columns: 16 rows where M <= 16, so a 2-row
//     decode does not pay for 64; 64 rows above;
//   - split-K where the output tiles alone would not fill the SMs
//     (decode, narrow projections): each split adds its uint32 partial
//     into a zeroed output with atomicAdd.  Addition mod 2^32 commutes,
//     so the result is bitwise the same in any order.
#include "common.cuh"

namespace {

constexpr int BK = 32;          // one m16n8k32 step of 8-bit digits
constexpr int DROW = BK + 16;   // bytes per digit row (ldmatrix conflict-free)
constexpr int MAX_BITS = 24;
constexpr int MAX_K = 16;
constexpr int MIN_SPLIT_STEPS = 4;  // k-steps a split covers at least

struct Params {
  int M, K, N;
  int Dx, Dw;
  uint32_t mask_x, mask_w, sub_x, sub_w;  // X' = (v & mask) - (v < 0 ? sub : 0)
  uint32_t bias_x, bias_w;                 // 0x80 in each of the D digit bytes
  int vec_x, vec_w;                        // 16-byte copies allowed
  int splits, steps, steps_per_split;
};

// The cp.async and ldmatrix helpers are shared with K5 (common.cuh).
using repro::cp16;
using repro::cp4;
using repro::cp_commit;
using repro::cp_wait;
using repro::ldmatrix_x4;

// d += a @ b on one m16n8k32 tile of s8 digits, s32 accumulation that
// wraps (no .satfinite).
__device__ __forceinline__ void mma_s8(uint32_t (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a @ b (a zero accumulator).
__device__ __forceinline__ void mma_s8_zero(int32_t (&d)[4], const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0));
}

// X' of one code -> a word whose byte i is its balanced digit i as s8:
// with bias = 0x80 in each of the D digit bytes, the bytes b_i of
// X' + bias (in [0, 256^D) for D = n_digits(B)) give
// X' = sum (b_i - 128) 256^i, and b_i ^ 0x80 is b_i - 128 as a
// two's-complement byte.
__device__ __forceinline__ uint32_t digits_of(int32_t v, uint32_t mask, uint32_t sub,
                                              uint32_t bias) {
  return ((((uint32_t)v & mask) - ((uint32_t)(v >> 31) & sub)) + bias) ^ bias;
}

// Four X' words (consecutive k) -> four digit words, word i holding
// digit i of each in k order (a 4 x 4 byte transpose).
__device__ __forceinline__ void digit_words(uint32_t x0, uint32_t x1, uint32_t x2,
                                            uint32_t x3, uint32_t (&d)[4]) {
  const uint32_t lo01 = __byte_perm(x0, x1, 0x5140);  // x0.b0 x1.b0 x0.b1 x1.b1
  const uint32_t hi01 = __byte_perm(x0, x1, 0x7362);  // x0.b2 x1.b2 x0.b3 x1.b3
  const uint32_t lo23 = __byte_perm(x2, x3, 0x5140);
  const uint32_t hi23 = __byte_perm(x2, x3, 0x7362);
  d[0] = __byte_perm(lo01, lo23, 0x5410);
  d[1] = __byte_perm(lo01, lo23, 0x7632);
  d[2] = __byte_perm(hi01, hi23, 0x5410);
  d[3] = __byte_perm(hi01, hi23, 0x7632);
}

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_;            // int32 tiles in flight
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;    // resident blocks an SM
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static constexpr int XS = BM * BK;             // int32 per x stage
  static constexpr int WS = BK * BN;             // int32 per w stage
  static_assert(WN % 16 == 0 && WM % 16 == 0 && BN % 32 == 0, "tile shape");
  // The int32 stages, then two buffers of digit planes (A, then B).
  __host__ __device__ static size_t digit_bytes(int Dx, int Dw) {
    return (size_t)(Dx * BM + Dw * BN) * DROW;
  }
  __host__ __device__ static size_t smem(int Dx, int Dw) {
    return (size_t)STAGES * (XS + WS) * sizeof(int32_t) + 2 * digit_bytes(Dx, Dw);
  }
};

// The 16-row tile takes 2 stages so that 3 blocks fit an SM (more stages
// leave room for fewer blocks, and a decode needs many independent
// streams).
using SmallTile = Tile<16, 128, 1, 4, 2, 3>;     // M <= 16: decode
using LargeTile = Tile<64, 128, 2, 4, 3, 2>;     // prefill, the compile GEMMs

// Issue the cp.async copies of k-step t into stage buffers xs / ws.
template <class T>
__device__ __forceinline__ void load_stage(const int32_t* __restrict__ xb,
                                           const int32_t* __restrict__ wb, int32_t* xs,
                                           int32_t* ws, int m0, int n0, int t,
                                           const Params& p) {
  const int k0 = t * BK;
  for (int c = threadIdx.x; c < T::BM * (BK / 4); c += T::THREADS) {
    const int r = c / (BK / 4), kc = c % (BK / 4);
    const int gm = m0 + r, gk = k0 + kc * 4;
    int32_t* dst = xs + r * BK + kc * 4;
    const int32_t* row = xb + (long long)gm * p.K;
    if (p.vec_x) {
      const bool ok = gm < p.M && gk < p.K;
      cp16(dst, ok ? row + gk : xb, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gm < p.M && gk + e < p.K;
        cp4(dst + e, ok ? row + gk + e : xb, ok ? 4 : 0);
      }
    }
  }
  // w rows are BN int32 = BN/4 chunks of 16 bytes; chunk c of row r is
  // stored at chunk c ^ ((r >> 2) & 7), so that the convert step's reads
  // of 4 rows x 1 chunk by 8 lanes hit 8 distinct bank groups.
  for (int c = threadIdx.x; c < BK * (T::BN / 4); c += T::THREADS) {
    const int r = c / (T::BN / 4), nc = c % (T::BN / 4);
    const int gk = k0 + r, gn = n0 + nc * 4;
    int32_t* dst = ws + r * T::BN + ((nc ^ ((r >> 2) & 7)) * 4);
    const int32_t* row = wb + (long long)gk * p.N;
    if (p.vec_w) {
      const bool ok = gk < p.K && gn < p.N;
      cp16(dst, ok ? row + gn : wb, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = gk < p.K && gn + e < p.N;
        cp4(dst + e, ok ? row + gn + e : wb, ok ? 4 : 0);
      }
    }
  }
}

// The staged int32 tiles -> digit planes dA [Dx][BM][DROW], dB [Dw][BN][DROW].
// Returns non-zero when this thread wrote a non-zero digit above the
// lowest (x or w).
template <class T>
__device__ __forceinline__ int convert_stage(const int32_t* xs, const int32_t* ws,
                                             uint8_t* dA, uint8_t* dB, const Params& p) {
  uint32_t high = 0u;
  for (int c = threadIdx.x; c < T::BM * (BK / 4); c += T::THREADS) {
    const int m = c / (BK / 4), kb = c % (BK / 4);
    const int4 v = *reinterpret_cast<const int4*>(xs + m * BK + kb * 4);
    uint32_t d[4];
    digit_words(digits_of(v.x, p.mask_x, p.sub_x, p.bias_x),
                digits_of(v.y, p.mask_x, p.sub_x, p.bias_x),
                digits_of(v.z, p.mask_x, p.sub_x, p.bias_x),
                digits_of(v.w, p.mask_x, p.sub_x, p.bias_x), d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < p.Dx) {
        *reinterpret_cast<uint32_t*>(dA + ((size_t)i * T::BM + m) * DROW + kb * 4) = d[i];
        if (i > 0) high |= d[i];
      }
  }
  for (int c = threadIdx.x; c < (BK / 4) * (T::BN / 4); c += T::THREADS) {
    const int kb = c % (BK / 4), nb = c / (BK / 4);
    int4 v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      v[r] = *reinterpret_cast<const int4*>(ws + (kb * 4 + r) * T::BN + ((nb ^ kb) * 4));
    const int32_t col[4][4] = {{v[0].x, v[1].x, v[2].x, v[3].x},
                               {v[0].y, v[1].y, v[2].y, v[3].y},
                               {v[0].z, v[1].z, v[2].z, v[3].z},
                               {v[0].w, v[1].w, v[2].w, v[3].w}};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t d[4];
      digit_words(digits_of(col[j][0], p.mask_w, p.sub_w, p.bias_w),
                  digits_of(col[j][1], p.mask_w, p.sub_w, p.bias_w),
                  digits_of(col[j][2], p.mask_w, p.sub_w, p.bias_w),
                  digits_of(col[j][3], p.mask_w, p.sub_w, p.bias_w), d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < p.Dw) {
          *reinterpret_cast<uint32_t*>(dB + ((size_t)i * T::BN + nb * 4 + j) * DROW +
                                       kb * 4) = d[i];
          if (i > 0) high |= d[i];
        }
    }
  }
  return high != 0u;
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
dcim_mvm_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ w,
                int32_t* __restrict__ out, Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* xs0 = reinterpret_cast<int32_t*>(smem);
  int32_t* ws0 = xs0 + T::STAGES * T::XS;
  uint8_t* digits0 = reinterpret_cast<uint8_t*>(ws0 + T::STAGES * T::WS);
  const size_t dbytes = T::digit_bytes(p.Dx, p.Dw);

  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const long long bt = blockIdx.z / p.splits;
  const int split = blockIdx.z % p.splits;
  const int32_t* xb = x + bt * p.M * (long long)p.K;
  const int32_t* wb = w + bt * p.K * (long long)p.N;

  const int t0 = split * p.steps_per_split;
  const int n_steps = min(p.steps, t0 + p.steps_per_split) - t0;

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp / T::WARPS_N;
  const int wn = warp % T::WARPS_N;

  // One uint32 accumulator set: the product of digit shift 8c > 0 is
  // formed alone and added shifted, so no set per shift is kept.
  uint32_t acc[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0u;

  // Every stage in flight; convert step 0.
#pragma unroll
  for (int s = 0; s < T::STAGES; ++s) {
    if (s < n_steps)
      load_stage<T>(xb, wb, xs0 + s * T::XS, ws0 + s * T::WS, m0, n0, t0 + s, p);
    cp_commit();
  }
  cp_wait<T::STAGES - 1>();
  __syncthreads();
  int high = 0;  // this thread's high digits of the step converted last
  if (n_steps > 0)
    high = convert_stage<T>(xs0, ws0, digits0, digits0 + p.Dx * T::BM * DROW, p);

  // ldmatrix row addresses: A x4 = (rows 0-7 | 8-15) x (bytes 0-15 | 16-31);
  // B x4 = (n 0-7 | 8-15) x (bytes 0-15 | 16-31), two n8 tiles.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + ((lane >> 4) & 1) * 8, b_col = ((lane >> 3) & 1) * 16;

  // Step it: land step it + 1, refill the stage step it used with step
  // it + STAGES, convert step it + 1 into the other digit buffer while
  // the tensor cores take step it's digit products.  Where no digit of
  // step it above the lowest is non-zero (in-range 8-bit codes), only
  // the low x low product is taken: the others add zeros.
  for (int it = 0; it < n_steps; ++it) {
    cp_wait<T::STAGES - 2>();
    const bool all_digits = __syncthreads_or(high) != 0;
    const int dx = all_digits ? p.Dx : 1;
    const int dw = all_digits ? p.Dw : 1;
    const int refill = it + T::STAGES;
    if (refill < n_steps) {
      const int s = it % T::STAGES;
      load_stage<T>(xb, wb, xs0 + s * T::XS, ws0 + s * T::WS, m0, n0, t0 + refill, p);
    }
    cp_commit();
    if (it + 1 < n_steps) {
      const int s = (it + 1) % T::STAGES;
      uint8_t* dA = digits0 + ((it + 1) & 1) * dbytes;
      high = convert_stage<T>(xs0 + s * T::XS, ws0 + s * T::WS, dA,
                              dA + p.Dx * T::BM * DROW, p);
    }

    const uint8_t* dA = digits0 + (it & 1) * dbytes;
    const uint8_t* dB = dA + p.Dx * T::BM * DROW;
    uint32_t bf[4][T::NT][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < dw)
#pragma unroll
        for (int np = 0; np < T::NT / 2; ++np) {
          uint32_t r[4];
          ldmatrix_x4(r, dB + ((size_t)j * T::BN + wn * T::WN + np * 16 + b_row) * DROW + b_col);
          bf[j][2 * np][0] = r[0];
          bf[j][2 * np][1] = r[1];
          bf[j][2 * np + 1][0] = r[2];
          bf[j][2 * np + 1][1] = r[3];
        }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i >= dx) break;
      uint32_t af[T::MT][4];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt)
        ldmatrix_x4(af[mt], dA + ((size_t)i * T::BM + wm * T::WM + mt * 16 + a_row) * DROW +
                                a_col);
#pragma unroll
      for (int j = 0; j < 4 - i; ++j) {
        if (j >= dw) break;
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < T::NT; ++nt) {
            if (i + j == 0) {
              mma_s8(acc[mt][nt], af[mt], bf[j][nt]);
            } else {
              int32_t t[4];
              mma_s8_zero(t, af[mt], bf[j][nt]);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mt][nt][e] += (uint32_t)t[e] << (8 * (i + j));
            }
          }
      }
    }
  }

  // Epilogue: fragment element e of an m16n8 tile is row g (+8 for
  // e >= 2), column 2 * tig + (e & 1).
  const int g = lane >> 2, tig = lane & 3;
  int32_t* ob = out + bt * p.M * (long long)p.N;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + wm * T::WM + mt * 16 + g + (e >> 1) * 8;
        const int gn = n0 + wn * T::WN + nt * 8 + tig * 2 + (e & 1);
        if (gm >= p.M || gn >= p.N) continue;
        int32_t* dst = ob + (long long)gm * p.N + gn;
        if (p.splits == 1)
          *dst = (int32_t)acc[mt][nt][e];
        else
          atomicAdd(reinterpret_cast<unsigned int*>(dst), acc[mt][nt][e]);
      }
}

int sm_count(int device) {
  static int cached[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n <= 0)
      n = 132;
    cached[device] = n;
  }
  return cached[device];
}

int tile_rows(int M) { return M <= SmallTile::BM ? SmallTile::BM : LargeTile::BM; }

// K-splits for a launch: 1 when the output tiles fill the card (8 blocks
// an SM for the 16-row tile, whose blocks are short of bytes in flight;
// 2 for the others); else enough splits to reach that, each covering at
// least MIN_SPLIT_STEPS k-steps, with Bt * splits within the grid's z
// limit.
int plan_splits(int Bt, int M, int K, int N, int device, int* steps_per_split) {
  const int bm = tile_rows(M);
  const long long tiles =
      (long long)Bt * ((M + bm - 1) / bm) * ((N + SmallTile::BN - 1) / SmallTile::BN);
  const int steps = (K + BK - 1) / BK;
  const long long target = (bm == SmallTile::BM ? 8LL : 2LL) * sm_count(device);
  int splits = 1;
  if (tiles > 0 && tiles < target) {
    const long long want = (target + tiles - 1) / tiles;
    const int most = steps / MIN_SPLIT_STEPS > 0 ? steps / MIN_SPLIT_STEPS : 1;
    splits = (int)(want < most ? want : most);
    const int z_most = 65535 / (Bt > 0 ? Bt : 1);
    if (splits > z_most) splits = z_most > 0 ? z_most : 1;
  }
  int per = steps > 0 ? (steps + splits - 1) / splits : 1;
  splits = steps > 0 ? (steps + per - 1) / per : 1;  // no empty split
  *steps_per_split = per;
  return splits;
}

template <class T>
int launch(const int32_t* x, const int32_t* w, int32_t* out, int Bt, Params p,
           cudaStream_t stream) {
  const size_t smem = T::smem(p.Dx, p.Dw);
  cudaError_t err = repro::allow_smem(dcim_mvm_kernel<T>, T::smem(4, 4));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.M + T::BM - 1) / T::BM, (p.N + T::BN - 1) / T::BN, Bt * p.splits);
  dcim_mvm_kernel<T><<<grid, T::THREADS, smem, stream>>>(x, w, out, p);
  return (int)cudaGetLastError();
}

// Balanced base-256 digits of a B-bit code: the least D with
// 127 (256^D - 1) / 255 >= 2^B - 1, the top of X'.
int n_digits(int bits) {
  int D = 1;
  while (D < 4 && 127ull * ((1ull << (8 * D)) - 1) / 255 < (1ull << bits) - 1) ++D;
  return D;
}

uint32_t digit_bias(int D) { return D >= 4 ? 0x80808080u : (0x80808080u & ((1u << (8 * D)) - 1u)); }

}  // namespace

// The launch plan for these sizes, launching nothing: the 8-bit digit
// products per k-step (i + j < 4) and the K-splits (1: none).
REPRO_EXPORT int dcim_mvm_plan(int Bt, int M, int K, int N, int B_x, int B_w, int device,
                               int* products, int* splits) {
  const int Dx = n_digits(B_x), Dw = n_digits(B_w);
  int n = 0;
  for (int i = 0; i < Dx; ++i)
    for (int j = 0; j < Dw; ++j) n += i + j < 4;
  int per = 0;
  *products = n;
  *splits = plan_splits(Bt, M, K, N, device, &per);
  return 0;
}

REPRO_EXPORT int dcim_mvm_launch(const int32_t* x, const int32_t* w,
                                 int32_t* out, int Bt, int M, int K, int N,
                                 int B_x, int B_w, int k, int x_signed,
                                 int w_signed, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B_x < 1 || B_x > MAX_BITS || B_w < 1 || B_w > MAX_BITS || k < 1 ||
      k > MAX_K)
    return (int)cudaErrorInvalidValue;
  if (Bt <= 0 || M <= 0 || N <= 0) return 0;
  if (N > 65535LL * SmallTile::BN || Bt > 65535) return (int)cudaErrorInvalidValue;
  Params p{};
  p.M = M;
  p.K = K;
  p.N = N;
  p.Dx = n_digits(B_x);
  p.Dw = n_digits(B_w);
  p.bias_x = digit_bias(p.Dx);
  p.bias_w = digit_bias(p.Dw);
  p.mask_x = (1u << B_x) - 1u;
  p.mask_w = (1u << B_w) - 1u;
  p.sub_x = x_signed ? (1u << B_x) : 0u;
  p.sub_w = w_signed ? (1u << B_w) : 0u;
  p.vec_x = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  p.steps = (K + BK - 1) / BK;
  p.splits = plan_splits(Bt, M, K, N, device, &p.steps_per_split);
  cudaStream_t s = (cudaStream_t)stream;
  if (p.splits > 1) {
    err = cudaMemsetAsync(out, 0, (size_t)Bt * M * N * sizeof(int32_t), s);
    if (err != cudaSuccess) return (int)err;
  }
  switch (tile_rows(M)) {
    case SmallTile::BM: return launch<SmallTile>(x, w, out, Bt, p, s);
    default: return launch<LargeTile>(x, w, out, Bt, p, s);
  }
}

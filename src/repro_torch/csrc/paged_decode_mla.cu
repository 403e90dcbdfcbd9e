// K6: paged absorbed-MLA decode attention, in the compressed c_kv space.
//
// Replaces repro/kernels/paged_attention.py:paged_decode_mla_pallas.
//
//   q_abs (B, 1, H, r) f32, q_rope (B, 1, H, dr), pages c_kv (n_pages,
//   page, r) / k_rope (n_pages, page, dr), block table bt (B, nb) int32,
//   pos (B,) int32
//   s[b, h, j]   = (q_abs[b, h] . c_kv_j + q_rope[b, h] . k_rope_j) * scale
//   out[b, 0, h] = sum_j softmax_j(s[b, h, j], j <= pos[b]) c_kv_j
//
// where key j of slot b lives in page bt[b, j / page], row j % page.  The
// scale multiplies the summed scores, as in the reference.  q_rope and the
// pages are each f32 or bf16 and are widened on load; everything after the
// load is f32, nothing is rounded to the page type (unlike K4/K5, which
// round the softmax weights before PV).  The output is the (B, 1, H, r) f32
// context; the w_uv up-projection stays with the caller.
//
// What bounds it on an H100: at the serve's shape (B 4, H 128, r 512, dr
// 64, ~400 live keys a slot) the function moves ~4 MB (the live c_kv /
// k_rope rows once, q_abs, q_rope, out), ~1.2 us at 3.35 TB/s, and does
// ~0.45 GFLOP, under 1 us on the tensor cores: bytes bound it.  This
// first kernel computes on the CUDA cores in f32, where the operations
// alone take ~7 us at 67 TFLOP/s, and every head re-reads the tile from
// shared memory, one load per multiply-add.
//
// Design: one CTA per (slot b, group of HB heads), one warp per head.
// All H heads of a slot read the same c_kv rows, so a CTA stages each
// tile of TN key rows (c_kv and k_rope, widened to f32) in shared memory
// once for its HB heads.  The TPU kernel gathered all nb pages into VMEM
// and ran one full masked softmax; here the CTA walks only the keys
// 0..pos[b], each row read through the block table, with an online
// softmax (running max and sum per head, f32).  Keys past pos[b] add
// exact zeros to the reference's softmax, so skipping them computes the
// same function.  A lane holds 1/32 of its head's q_abs and of its
// r-wide accumulator in registers (d = i * 32 + lane), so the dot
// products read consecutive shared-memory words (no bank conflicts); the
// 32 keys' partial sums then meet in one transposed warp sum that leaves
// key j's score in lane j, for the softmax step.  The PV step reads the
// same rows again with the weights broadcast from shared memory.  HB = 4
// gives B * H / 4 CTAs (128 at the serve's shape, one wave on 132 SMs).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int TN = 32;        // keys per tile: one per lane in the softmax step
constexpr int HB = 4;         // heads per CTA, one warp each
constexpr int THREADS = HB * 32;
constexpr int DRL = 4;        // q_rope registers a lane: dr <= 128
constexpr int DRS = DRL * 32; // k_rope row stride in shared memory

// Sum 32 per-key partials over the warp's lanes so that lane j ends with
// key j's total: five halving exchanges, 31 shuffles in all (against
// 5 * 32 for a butterfly per key).  Each exchange is its own instance, so
// every register index is fixed at compile time and v stays in registers.
template <int O>
__device__ __forceinline__ void halve(float (&v)[TN], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float mine = up ? v[k + O] : v[k];
    const float other = up ? v[k] : v[k + O];
    v[k] = mine + __shfl_xor_sync(0xffffffffu, other, O);
  }
}

__device__ __forceinline__ float transpose_sum(float (&v)[TN], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

// RL registers of q_abs and of the accumulator a lane: r <= RL * 32.
template <typename TQR, typename TKV, int RL>
__global__ void __launch_bounds__(THREADS)
paged_decode_mla_kernel(const float* __restrict__ q_abs, const TQR* __restrict__ q_rope,
                        const TKV* __restrict__ cp, const TKV* __restrict__ rp,
                        const int32_t* __restrict__ bt, const int32_t* __restrict__ pos,
                        float* __restrict__ out, int H, int r, int dr, int page, int nb,
                        int n_pages, float scale) {
  constexpr int RS = RL * 32;    // c_kv row stride in shared memory
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int h = blockIdx.y * HB + warp;
  const bool live_head = h < H;
  float* c_s = smem;               // TN * RS: the tile's c_kv rows
  float* k_s = c_s + TN * RS;      // TN * DRS: its k_rope rows
  float* p_s = k_s + TN * DRS;     // HB * TN: each head's softmax weights

  // Columns past r / dr stay zero, and so do rows no tile has filled yet:
  // every row a lane reads is finite, so the dot products below need no
  // guards (their q registers past r / dr are zero as well).
  for (int i = threadIdx.x; i < TN * (RS + DRS); i += THREADS) smem[i] = 0.0f;

  const int last = min(max(pos[b], 0), nb * page - 1);   // keys 0..last attended
  const int32_t* bt_row = bt + (long long)b * nb;

  float q[RL], acc[RL], qr[DRL];
  const long long row = (long long)b * H + (live_head ? h : 0);
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int d = i * 32 + lane;
    q[i] = (live_head && d < r) ? q_abs[row * r + d] : 0.0f;
    acc[i] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < DRL; ++k) {
    const int d = k * 32 + lane;
    qr[k] = (live_head && d < dr) ? repro::to_f32(q_rope[row * dr + d]) : 0.0f;
  }
  float m = -INFINITY;             // running max and sum of this warp's head
  float l = 0.0f;
  __syncthreads();

  for (int t0 = 0; t0 <= last; t0 += TN) {
    const int n = min(TN, last - t0 + 1);   // live rows of this tile
    for (int j = warp; j < n; j += HB) {
      const int key = t0 + j;
      const long long src = (long long)min(bt_row[key / page], n_pages - 1) * page + key % page;
      for (int d = lane; d < r; d += 32) c_s[j * RS + d] = repro::to_f32(cp[src * r + d]);
      for (int d = lane; d < dr; d += 32) k_s[j * DRS + d] = repro::to_f32(rp[src * dr + d]);
    }
    __syncthreads();

    // Scores: each lane takes its 1/32 of every row's dot product (rows
    // past n hold an earlier tile's keys or zeros, and are masked below),
    // then the transposed sum leaves key `lane`'s score in lane `lane`.
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < RL; ++i) part = fmaf(q[i], c_s[j * RS + i * 32 + lane], part);
#pragma unroll
      for (int k = 0; k < DRL; ++k) part = fmaf(qr[k], k_s[j * DRS + k * 32 + lane], part);
      v[j] = part;
    }
    const float dot = transpose_sum(v, lane);
    const float s = lane < n ? dot * scale : -INFINITY;

    // Online softmax, one key per lane.  The tile's first key (t0 <= last)
    // is always live, so the running max stays finite.
    float mx = s;
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);
    const float p = lane < n ? expf(s - m_new) : 0.0f;
    float sum = p;
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float alpha = expf(m - m_new);     // 0 on the first tile
    l = l * alpha + sum;
    m = m_new;
    float* pw = p_s + warp * TN;
    pw[lane] = p;
    __syncwarp();

#pragma unroll
    for (int i = 0; i < RL; ++i) acc[i] *= alpha;
    for (int j = 0; j < n; ++j) {
      const float pj = pw[j];
#pragma unroll
      for (int i = 0; i < RL; ++i) acc[i] = fmaf(pj, c_s[j * RS + i * 32 + lane], acc[i]);
    }
    __syncthreads();                          // the next tile overwrites c_s, k_s, p_s
  }

  if (!live_head) return;
  float* o = out + row * r;
#pragma unroll
  for (int i = 0; i < RL; ++i) {
    const int d = i * 32 + lane;
    if (d < r) o[d] = acc[i] / l;
  }
}

template <typename TQR, typename TKV, int RL>
int launch(const float* q_abs, const void* q_rope, const void* cp, const void* rp,
           const int32_t* bt, const int32_t* pos, float* out, int B, int H, int r, int dr,
           int page, int nb, int n_pages, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)TN * (RL * 32 + DRS) + (size_t)HB * TN);
  auto kernel = paged_decode_mla_kernel<TQR, TKV, RL>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, (H + HB - 1) / HB), THREADS, smem, stream>>>(
      q_abs, static_cast<const TQR*>(q_rope), static_cast<const TKV*>(cp),
      static_cast<const TKV*>(rp), bt, pos, out, H, r, dr, page, nb, n_pages, scale);
  return (int)cudaGetLastError();
}

template <typename TQR, typename TKV>
int launch_rank(const float* q_abs, const void* q_rope, const void* cp, const void* rp,
                const int32_t* bt, const int32_t* pos, float* out, int B, int H, int r, int dr,
                int page, int nb, int n_pages, float scale, cudaStream_t stream) {
  if (r <= 16 * 32)
    return launch<TQR, TKV, 16>(q_abs, q_rope, cp, rp, bt, pos, out, B, H, r, dr, page, nb,
                                n_pages, scale, stream);
  return launch<TQR, TKV, 32>(q_abs, q_rope, cp, rp, bt, pos, out, B, H, r, dr, page, nb,
                              n_pages, scale, stream);
}

}  // namespace

REPRO_EXPORT int paged_decode_mla_launch(const void* q_abs, const void* q_rope, const void* cp,
                                         const void* rp, const int32_t* bt,
                                         const int32_t* pos, float* out, int B, int H, int r,
                                         int dr, int page, int nb, int n_pages, float scale,
                                         int qr_bf16, int kv_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0) return 0;
  if (r < 1 || r > 32 * 32 || dr < 1 || dr > DRL * 32 || nb < 1 || page < 1 ||
      (H + HB - 1) / HB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* qa = static_cast<const float*>(q_abs);
  using bf16 = __nv_bfloat16;
  if (qr_bf16 && kv_bf16)
    return launch_rank<bf16, bf16>(qa, q_rope, cp, rp, bt, pos, out, B, H, r, dr, page, nb, n_pages, scale, s);
  if (qr_bf16)
    return launch_rank<bf16, float>(qa, q_rope, cp, rp, bt, pos, out, B, H, r, dr, page, nb, n_pages, scale, s);
  if (kv_bf16)
    return launch_rank<float, bf16>(qa, q_rope, cp, rp, bt, pos, out, B, H, r, dr, page, nb, n_pages, scale, s);
  return launch_rank<float, float>(qa, q_rope, cp, rp, bt, pos, out, B, H, r, dr, page, nb, n_pages, scale, s);
}

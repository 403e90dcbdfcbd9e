// K5: [reused context ; causal tail] prefill attention.
//
// Replaces repro/kernels/paged_attention.py:prefix_prefill_pallas.
//
//   q (B, T, H, hd) tail queries; k/v_ctx (B, L, Hk, hd[v]) gathered
//   context (absent when L = 0); k/v_tail (B, T, Hk, hd[v]); ctx_len (B,)
//   out[b, t, h*G + g] = softmax over [ctx ; tail] of q . k / sqrt(hd),
//   context column j valid iff j < ctx_len[b], tail column c iff c <= t
//
// q and the K/V operands are each f32 or bf16 (context and tail share a
// type); scores, softmax and the output are f32.  As in the plain
// version, q * (1/sqrt(hd)) is rounded to q's type and the softmax
// weights to the K/V type before the PV product.
//
// What bounds it on an H100: bytes, with the products close behind.  At
// qwen2.5-3b's serve shape (4 tails of 256 over 1024 context rows with
// ctx_len 256; 16 heads of 128 over 2 KV heads) the operands are 14.7
// MB, 0.0044 ms at 3.35 TB/s, and scores plus PV 3.2 GFLOP, 0.0033 ms
// at the bf16 tensor-core rate; at deepseek-v3's MLA shape (128 heads,
// hd 192, hdv 128, G = 1) 0.085 ms of bytes against 0.033 ms of
// products.  On the CUDA cores in f32 (67 TFLOP/s) the products alone
// take 15x as long as on the tensor cores, so they go to the tensor
// cores, and the K/V tiles must land while the previous tile is
// multiplied.
//
// Two kernels, chosen by type alone before the launch:
//
// prefix_prefill_mma_kernel (q, K and V all bf16, the serve type): a
// flash-attention-2 walk on mma.sync m16n8k16 bf16 -> f32.
//   - Rows: for one (row b, KV head h) the tail's queries are flattened
//     as r = t*G + g; a CTA of 4 warps takes 64 consecutive rows, 16 a
//     warp, so all G heads of a position share every K/V tile it loads,
//     for any G.  Grid (ceil(T*G / 64), Hk, B).
//   - Q is staged once as bf16(q * scale) (the plain version's
//     rounding); K/V tiles of BN keys (64; 32 where hdv > 128, for
//     registers, or hd > 128, so that three CTAs fit an SM at MLA's hd
//     192) stream through a two-stage cp.async ring, 16-byte
//     copies (4-byte or element copies where rows are not 16-byte
//     aligned), so tile i + 1 lands while tile i is multiplied.  Head
//     dims are zero-padded in shared memory to a multiple of 16, which
//     is exact; rows are padded by 16 bytes so ldmatrix reads them free
//     of bank conflicts.
//   - The walk takes the context columns [0, n_ctx), then the tail
//     columns [0, t_hi], t_hi the CTA's last real position: tail tiles
//     past it are never loaded, and a warp skips a tail tile that starts
//     past its own last position.  Only the last context tile and the
//     tail tiles across the diagonal are masked.
//   - S = Q K^T through ldmatrix -> mma, f32 in registers; an online
//     softmax per row (max and sum over the quad by shuffles, expf of
//     the score minus the running max); the unnormalised weights are
//     rounded to bf16 and used from registers as PV's A operand, V read
//     by ldmatrix.trans; O stays in f32 registers, rescaled per tile and
//     divided by the row sum at the end.
//   - The first tile walked (context column 0 when ctx_len > 0, else
//     tail column 0) is live for every row, so each row's running max is
//     finite from then on and zero-padded or ragged rows stay finite.
//     Fully masked columns contribute exact zeros to the reference's
//     softmax, so skipping them computes the same function.
//
// prefix_prefill_kernel (the pairs with an f32 operand, held at 1e-5,
// which bf16 or TF32 products cannot meet): the same walk on the CUDA
// cores in f32, one CTA per (tile of Tt tail queries, KV head h, row b)
// with R = Tt * G query rows, K/V tiles of 32 keys staged as f32.
#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- tensor-core kernel (bf16 q, K and V) ---------------------------------

constexpr int MMA_ROWS = 64;       // flattened (position, head) rows a CTA
constexpr int MMA_THREADS = 128;   // 4 warps of 16 rows
constexpr int PAD = 8;             // bf16 past each shared-memory row

// Start the copies of `rows` shared-memory rows of `padded` bf16 (row
// stride `stride`): rows j < n from src + j * row_step, `width` elements
// each, the rest zero (copies by `vec`, as repro::copy_chunk).  Thread i
// takes chunks i, i + MMA_THREADS, ... of 8 elements, its (row, chunk)
// stepped without a division.
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int n,
                                           int rows, int width, int padded, int stride,
                                           long long row_step, int vec) {
  const int chunks = padded / 8;
  const int dj = MMA_THREADS / chunks, dc = MMA_THREADS - dj * chunks;
  int j = threadIdx.x / chunks, c = threadIdx.x - j * chunks;
  while (j < rows) {
    const int d0 = c * 8;
    const int valid = j < n ? max(0, min(8, width - d0)) : 0;
    repro::copy_chunk(dst + j * stride + d0, src + j * row_step + d0, src, valid, vec);
    j += dj;
    c += dc;
    if (c >= chunks) {
      c -= chunks;
      ++j;
    }
  }
}

template <int DV, int BN>
__global__ void __launch_bounds__(MMA_THREADS)
prefix_prefill_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                          const bf16* __restrict__ vc, const bf16* __restrict__ kt,
                          const bf16* __restrict__ vt, const int32_t* __restrict__ ctx_len,
                          float* __restrict__ out, int T, int L, int H, int Hk, int hd, int hdv,
                          int dkp, float scale, int vec_q, int vec_kv) {
  static_assert(DV % 16 == 0 && BN % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = dkp + PAD;                 // Q and K row stride (bf16)
  constexpr int VS = DV + PAD;              // V row stride
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // MMA_ROWS x ks
  bf16* k_s = q_s + MMA_ROWS * ks;                   // 2 stages of BN x ks
  bf16* v_s = k_s + 2 * BN * ks;                     // 2 stages of BN x VS

  const int r0 = blockIdx.x * MMA_ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t_hi = min(T - 1, (r0 + MMA_ROWS - 1) / G);   // the CTA's last real position
  const int n_ctx = L > 0 ? min(max(ctx_len[b], 0), L) : 0;
  const int ctx_tiles = (n_ctx + BN - 1) / BN;
  const int n_tiles = ctx_tiles + (t_hi + BN) / BN;

  auto tile_c0 = [&](int i) { return (i < ctx_tiles ? i : i - ctx_tiles) * BN; };
  auto load_tile = [&](int i) {
    const bool ctx = i < ctx_tiles;
    const int c0 = tile_c0(i);
    const int n = min(BN, (ctx ? n_ctx : t_hi + 1) - c0);
    const long long row0 = (long long)b * (ctx ? L : T) + c0;
    const int st = i & 1;
    stage_rows(k_s + st * BN * ks, (ctx ? kc : kt) + (row0 * Hk + h) * hd, n, BN, hd, dkp, ks,
               (long long)Hk * hd, vec_kv);
    stage_rows(v_s + st * BN * VS, (ctx ? vc : vt) + (row0 * Hk + h) * hdv, n, BN, hdv, DV, VS,
               (long long)Hk * hdv, vec_kv);
    repro::cp_commit();
  };
  load_tile(0);

  // Q, scaled and rounded to bf16; rows past T and columns past hd zero.
  const int q_chunks = dkp / 8;
  for (int i = threadIdx.x; i < MMA_ROWS * q_chunks; i += MMA_THREADS) {
    const int rr = i / q_chunks;
    const int d0 = (i - rr * q_chunks) * 8;
    const int r = r0 + rr;
    const int t = r / G;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.0f;
    if (t < T && d0 < hd) {
      const bf16* src = q + (((long long)b * T + t) * H + (long long)h * G + (r - t * G)) * hd + d0;
      if (vec_q) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        const bf16* e8 = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(e8[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (d0 + e < hd) x[e] = __bfloat162float(src[e]);
      }
    }
    uint4 w;
    w.x = repro::pack_bf16(x[0] * scale, x[1] * scale);
    w.y = repro::pack_bf16(x[2] * scale, x[3] * scale);
    w.z = repro::pack_bf16(x[4] * scale, x[5] * scale);
    w.w = repro::pack_bf16(x[6] * scale, x[7] * scale);
    *reinterpret_cast<uint4*>(q_s + rr * ks + d0) = w;
  }

  // This thread's rows of the warp's 16 (lane / 4 and lane / 4 + 8) and
  // key columns (2 * (lane % 4) + {0, 1} of each 8-column tile).
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int wr = r0 + warp * 16;
  const int t_row0 = (wr + g) / G;
  const int t_row1 = (wr + g + 8) / G;
  const int t_warp_lo = wr / G;
  const int t_warp_hi = (wr + 15) / G;
  // ldmatrix row addresses: A (Q) 16 x 16, B (K) two n-tiles x 16 deep,
  // B (V, transposed) 16 deep x two n-tiles.
  const int a_off = (warp * 16 + (lane & 15)) * ks + (lane >> 4) * 8;
  const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * ks + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * VS + (lane >> 4) * 8;

  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows g, g + 8
  float l0 = 0.0f, l1 = 0.0f;             // this thread's share of their sums

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      load_tile(i + 1);
      repro::cp_wait<1>();
    } else {
      repro::cp_wait<0>();
    }
    __syncthreads();
    const bool ctx = i < ctx_tiles;
    const int c0 = tile_c0(i);
    if (ctx || c0 <= t_warp_hi) {
      const bf16* kb = k_s + (i & 1) * BN * ks;
      const bf16* vb = v_s + (i & 1) * BN * VS;
      float s[BN / 8][4];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
      for (int kk = 0; kk < dkp; kk += 16) {
        uint32_t a[4];
        repro::ldmatrix_x4(a, q_s + a_off + kk);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t bk[4];
          repro::ldmatrix_x4(bk, kb + np * 16 * ks + k_off + kk);
          repro::mma_bf16(s[2 * np], a, bk[0], bk[1]);
          repro::mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
        }
      }
      const int n_cols = ctx ? n_ctx : t_hi + 1;
      if (c0 + BN > n_cols || (!ctx && c0 + BN - 1 > t_warp_lo)) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + n * 8 + 2 * qd + (e & 1);
            if (col >= n_cols || (!ctx && col > (e < 2 ? t_row0 : t_row1)))
              s[n][e] = -INFINITY;
          }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float al0 = expf(m0 - mx0);    // 0 on a row's first tile
      const float al1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      // The weights, unnormalised, rounded to bf16 as PV's A operand:
      // k-step j covers key n-tiles 2j and 2j + 1.
      uint32_t p[BN / 16][4];
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        const float e0 = expf(s[n][0] - m0), e1 = expf(s[n][1] - m0);
        const float e2 = expf(s[n][2] - m1), e3 = expf(s[n][3] - m1);
        sum0 += e0 + e1;
        sum1 += e2 + e3;
        p[n / 2][(n & 1) * 2] = repro::pack_bf16(e0, e1);
        p[n / 2][(n & 1) * 2 + 1] = repro::pack_bf16(e2, e3);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        o[n][0] *= al0;
        o[n][1] *= al0;
        o[n][2] *= al1;
        o[n][3] *= al1;
      }
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
#pragma unroll
        for (int dp = 0; dp < DV / 16; ++dp) {
          uint32_t bv[4];
          repro::ldmatrix_x4_trans(bv, vb + j * 16 * VS + v_off + dp * 16);
          repro::mma_bf16(o[2 * dp], p[j], bv[0], bv[1]);
          repro::mma_bf16(o[2 * dp + 1], p[j], bv[2], bv[3]);
        }
    }
    __syncthreads();                       // stage i & 1 is free for tile i + 2
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wr + g + 8 * half;
    const int t = half ? t_row1 : t_row0;
    if (t >= T) continue;
    const float l = half ? l1 : l0;
    float* orow = out + (((long long)b * T + t) * H + (long long)h * G + (r - t * G)) * hdv;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = n * 8 + 2 * qd;
      const float y0 = o[n][2 * half] / l, y1 = o[n][2 * half + 1] / l;
      if ((hdv & 1) == 0 && col + 1 < hdv) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(y0, y1);
      } else {
        if (col < hdv) orow[col] = y0;
        if (col + 1 < hdv) orow[col + 1] = y1;
      }
    }
  }
}

template <int DV, int BN>
int launch_mma(const void* q, const void* kc, const void* vc, const void* kt, const void* vt,
               const int32_t* ctx_len, float* out, int B, int T, int L, int H, int Hk, int hd,
               int hdv, float scale, cudaStream_t stream) {
  const int dkp = (hd + 15) / 16 * 16;
  const size_t smem = sizeof(bf16) * ((size_t)(MMA_ROWS + 2 * BN) * (dkp + PAD) +
                                      2 * (size_t)BN * (DV + PAD));
  auto kernel = prefix_prefill_mma_kernel<DV, BN>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const void* kv[4] = {kt, vt, L > 0 ? kc : nullptr, L > 0 ? vc : nullptr};
  bool a16 = hd % 8 == 0 && hdv % 8 == 0, a4 = hd % 2 == 0 && hdv % 2 == 0;
  for (const void* p : kv) {
    a16 = a16 && repro::aligned(p, 16);
    a4 = a4 && repro::aligned(p, 4);
  }
  const int vec_kv = a16 ? 16 : (a4 ? 4 : 2);
  const int vec_q = hd % 8 == 0 && repro::aligned(q, 16);
  const long long rows = (long long)T * (H / Hk);
  const dim3 grid((unsigned)((rows + MMA_ROWS - 1) / MMA_ROWS), Hk, B);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kc), static_cast<const bf16*>(vc),
      static_cast<const bf16*>(kt), static_cast<const bf16*>(vt), ctx_len, out, T, L, H, Hk,
      hd, hdv, dkp, scale, vec_q, vec_kv);
  return (int)cudaGetLastError();
}

// ---- CUDA-core kernel (an f32 operand) ------------------------------------

constexpr int TN = 32;        // keys per tile: one per lane in the softmax step
constexpr int THREADS = 256;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
prefix_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                      const TKV* __restrict__ vc, const TKV* __restrict__ kt,
                      const TKV* __restrict__ vt, const int32_t* __restrict__ ctx_len,
                      float* __restrict__ out, int T, int L, int H, int Hk, int hd,
                      int hdv, int Tt, float scale) {
  extern __shared__ float smem[];
  const int t0 = blockIdx.x * Tt;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hk;
  const int R = Tt * G;                 // query rows: r -> (t0 + r / G, head h*G + r % G)
  const int ks = hd + 1;
  const int vs = hdv + 1;
  float* q_s = smem;                    // R * hd
  float* k_s = q_s + R * hd;            // TN * ks
  float* v_s = k_s + TN * ks;           // TN * vs
  float* p_s = v_s + TN * vs;           // R * TN
  float* o_s = p_s + R * TN;            // R * hdv
  float* m_s = o_s + R * hdv;           // R
  float* l_s = m_s + R;                 // R
  float* a_s = l_s + R;                 // R

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t_hi = min(T - 1, t0 + Tt - 1);      // this tile's last real query
  const int n_ctx = L > 0 ? min(max(ctx_len[b], 0), L) : 0;

  for (int i = tid; i < R * hd; i += THREADS) {
    const int r = i / hd;
    const int d = i - r * hd;
    const int t = t0 + r / G;
    float x = 0.0f;                      // rows past T: zero queries, never written
    if (t < T)
      x = repro::to_f32(q[(((long long)b * T + t) * H + (long long)h * G + r % G) * hd + d]);
    q_s[i] = repro::round_to<TQ>(x * scale);
  }
  for (int i = tid; i < R * hdv; i += THREADS) o_s[i] = 0.0f;
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }
  __syncthreads();

  // Phase 0 walks the context columns [0, n_ctx), phase 1 the tail
  // columns [0, t_hi].
  for (int phase = 0; phase < 2; ++phase) {
    const int n_cols = phase == 0 ? n_ctx : t_hi + 1;
    const int rows = phase == 0 ? L : T;
    const TKV* kb = (phase == 0 ? kc : kt) + (long long)b * rows * Hk * hd;
    const TKV* vb = (phase == 0 ? vc : vt) + (long long)b * rows * Hk * hdv;
    for (int c0 = 0; c0 < n_cols; c0 += TN) {
      const int n = min(TN, n_cols - c0);
      for (int i = tid; i < n * hd; i += THREADS) {
        const int j = i / hd;
        const int d = i - j * hd;
        k_s[j * ks + d] = repro::to_f32(kb[((long long)(c0 + j) * Hk + h) * hd + d]);
      }
      for (int i = tid; i < n * hdv; i += THREADS) {
        const int j = i / hdv;
        const int d = i - j * hdv;
        v_s[j * vs + d] = repro::to_f32(vb[((long long)(c0 + j) * Hk + h) * hdv + d]);
      }
      __syncthreads();

      for (int i = tid; i < R * TN; i += THREADS) {
        const int r = i / TN;
        const int j = i - r * TN;
        const int c = c0 + j;
        // Context columns < n_ctx are live for every row; tail column c
        // for rows at t >= c.
        const bool live = j < n && (phase == 0 || c <= t0 + r / G);
        float s = -INFINITY;
        if (live) {
          const float* qr = q_s + r * hd;
          const float* kr = k_s + j * ks;
          float acc = 0.0f;
          for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
          s = acc;
        }
        p_s[i] = s;
      }
      __syncthreads();

      for (int r = warp; r < R; r += THREADS / 32) {
        const float s = p_s[r * TN + lane];
        float mx = s;
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float p = s == -INFINITY ? 0.0f : expf(s - m_new);
        float sum = p;
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        p_s[r * TN + lane] = repro::round_to<TKV>(p);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);   // 0 on a row's first tile
          a_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      for (int i = tid; i < R * hdv; i += THREADS) {
        const int r = i / hdv;
        const int d = i - r * hdv;
        const float* pr = p_s + r * TN;
        float acc = o_s[i] * a_s[r];
        for (int j = 0; j < n; ++j) acc = fmaf(pr[j], v_s[j * vs + d], acc);
        o_s[i] = acc;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < R * hdv; i += THREADS) {
    const int r = i / hdv;
    const int t = t0 + r / G;
    if (t < T)
      out[(((long long)b * T + t) * H + (long long)h * G + r % G) * hdv + (i - r * hdv)] =
          o_s[i] / l_s[r];
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kc, const void* vc, const void* kt, const void* vt,
           const int32_t* ctx_len, float* out, int B, int T, int L, int H, int Hk, int hd,
           int hdv, int Tt, float scale, cudaStream_t stream) {
  const int R = Tt * (H / Hk);
  const size_t smem =
      sizeof(float) * ((size_t)R * hd + (size_t)TN * (hd + 1) + (size_t)TN * (hdv + 1) +
                       (size_t)R * TN + (size_t)R * hdv + 3 * (size_t)R);
  auto kernel = prefix_prefill_kernel<TQ, TKV>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + Tt - 1) / Tt, Hk, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kc), static_cast<const TKV*>(vc),
      static_cast<const TKV*>(kt), static_cast<const TKV*>(vt), ctx_len, out, T, L, H, Hk,
      hd, hdv, Tt, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, K and V all bf16: the tensor-core kernel.
REPRO_EXPORT int prefix_prefill_mma_launch(const void* q, const void* kc, const void* vc,
                                           const void* kt, const void* vt,
                                           const int32_t* ctx_len, float* out, int B, int T,
                                           int L, int H, int Hk, int hd, int hdv, float scale,
                                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0) return 0;
  if (B > 65535 || Hk < 1 || Hk > 65535 || H % Hk != 0 || hd < 1 || hd > 256 || hdv < 1 ||
      hdv > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (hdv <= 32)
    return launch_mma<32, 64>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, scale, s);
  if (hdv <= 64)
    return launch_mma<64, 64>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, scale, s);
  if (hdv <= 128 && hd <= 128)
    return launch_mma<128, 64>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, scale, s);
  if (hdv <= 128)   // hd above 128 (MLA's 192): 32-key tiles leave room for 3 CTAs an SM
    return launch_mma<128, 32>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, scale, s);
  if (hdv <= 192)
    return launch_mma<192, 32>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, scale, s);
  return launch_mma<256, 32>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, scale, s);
}

// A pair with an f32 operand: the CUDA-core kernel (bf16 q, K and V take
// prefix_prefill_mma_launch and are refused here).
REPRO_EXPORT int prefix_prefill_launch(const void* q, const void* kc, const void* vc,
                                       const void* kt, const void* vt,
                                       const int32_t* ctx_len, float* out, int B, int T,
                                       int L, int H, int Hk, int hd, int hdv, int Tt,
                                       float scale, int q_bf16, int kv_bf16, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0) return 0;
  if (B > 65535 || Hk > 65535 || H % Hk != 0 || Tt < 1 || (q_bf16 && kv_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_bf16)
    return launch<bf16, float>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, Tt, scale, s);
  if (kv_bf16)
    return launch<float, bf16>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, Tt, scale, s);
  return launch<float, float>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, Tt, scale, s);
}

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
// where key j of slot b lives in page bt[b, j / page], row j % page
// (entries clamped to the pool).  The scale multiplies the summed scores,
// as in the reference.  Everything the kernels compute is float32 to
// within the tensor cores' f32 accumulation: nothing is rounded to the
// page type (unlike K4/K5, which round the softmax weights before PV).
// The output is the (B, 1, H, r) f32 context; the w_uv up-projection
// stays with the caller.  Keys past pos[b] add exact zeros to the
// reference's softmax, so walking only 0..pos[b] computes the same
// function.
//
// What bounds it on an H100: at the serve's shape (B 4, H 128, r 512, dr
// 64, ~400 live keys a slot) the function moves ~4 MB (the live c_kv /
// k_rope rows once, q_abs, q_rope, out), ~1.2 us at 3.35 TB/s, and does
// ~0.45 GFLOP: bytes bound it.  The wrapper chooses one of two kernels by
// the pages' dtype alone:
//
// bf16 pages (every serve launch): the split walk on bf16 mma.sync, then
// its merge.
//   - Exact bf16 planes.  A bf16 page row is exact as an mma.sync operand.
//     Each f32 x of q_abs (and of an f32 q_rope) is cut into x0 =
//     bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1): every
//     difference is exact in f32 and the remainders hold <= 16 and <= 8
//     significant bits, so x0 + x1 + x2 = x for every normal x (down to
//     ~2^-110, where x2 would fall below bf16's normal range).  Each
//     plane x page product is exact in f32, so the scores differ from
//     the plain version by the f32 accumulation and its order only, and
//     the output holds 1e-5.  The unnormalised softmax weights p are cut
//     the same way before PV.  TF32 (10-bit mantissa) misses 1e-5, and
//     two TF32 planes cost as much as four bf16 ones.
//   - Grid (B x ceil(H / 16), splits).  Split s of slot b takes the keys
//     of pages [s * pps, (s + 1) * pps), clipped at pos[b]; a CTA whose
//     run starts past pos[b] returns at once.  The split index is the
//     slowest, so the low splits, live at any pos, are launched first.  The wrapper sizes pps from
//     the shapes alone (paged_attention.mla_decode_split: about two waves
//     of CTAs, so about one of live ones at half the pool; at least one
//     tile a split): reading pos on the host would sync.
//   - A CTA is 4 warps and 16 heads of one slot (one m16 row tile; rows
//     past H are zero).  Q is staged once, as three planes of rows of
//     [q_abs ; q_rope] bf16 (widths padded to 16, rows by 16 bytes, so
//     ldmatrix is conflict-free).  Tiles of TK key rows of [c_kv ;
//     k_rope] go through a cp.async ring (two stages where they fit,
//     else one), each row found through the block table once and copied
//     as 16-byte chunks (4-byte or element copies where rows are off
//     16-byte alignment), zero past the widths and past the split's keys.
//   - Scores: each warp takes TK / 4 keys of the tile over the full r +
//     dr, ldmatrix -> mma.sync m16n8k16 bf16 -> f32 with one accumulator
//     set a plane (independent chains), the sets summed at the end.  An
//     f32 q_rope takes 3 planes over its columns, a bf16 one 1 (exact as
//     it is).  The warps' score blocks meet in shared memory as a 16 x TK
//     f32 block.
//   - One online softmax for the CTA: every warp takes the same step from
//     the whole block (the row max over TK keys, keys past the split's
//     end at -inf), so all four carry identical (max, sum) and rescale
//     by the same factor; nothing is merged between warps.
//   - PV: each warp takes r / 4 output columns (DV, up to 128
//     accumulators a lane at r 1024), A = the weights' 3 planes from
//     registers, B = the tile's c_kv columns by ldmatrix.trans.
//   - MMAs a full 64-key tile and 16 heads at r 512, dr 64: scores 4
//     warps x 32 k-steps x 2 n-tiles x 3 planes = 768 over c_kv, plus 4 x
//     4 x 2 x (1 for a bf16 q_rope, 3 for f32) = 32 (96) over k_rope; PV
//     4 warps x 4 k-steps x 16 n-tiles x 3 planes = 768.  1568 in all
//     (1632 with an f32 q_rope), ~3.4x the function's products.
//   - Each CTA writes one partial per head (the unnormalised r-wide row,
//     its max and sum) to a float32 workspace the wrapper allocates; the
//     merge launch, one CTA per (slot, head), reads pos[b] and folds the
//     live splits.  No atomics: two calls give the same bits.
// paged_decode_mla_kernel (f32 pages, held at 1e-5): the CUDA-core kernel.
//   One CTA per (slot b, group of HB heads), one warp per head; each tile
//   of TN key rows staged in shared memory once for its HB heads; a lane
//   holds 1/32 of its head's q_abs and r-wide accumulator in registers;
//   an online softmax (running max and sum per head, f32).
#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- tensor-core split walk (bf16 pages) -----------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps
constexpr int MMA_ROWS = 16;       // heads a CTA: one m16 row tile
constexpr int PAD = 8;             // bf16 past each shared-memory row
constexpr int SC_PAD = 8;          // f32 past each score row

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(repro::smem_u32(p)));
}

// x = x0 + x1 + x2 exactly (x normal, |x| >= ~2^-110), each a bf16.
__device__ __forceinline__ void split3(float x, bf16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(p[0]));
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(p[1])));
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 elements of a Q row from s as float (the first `valid`, the rest 0):
// 16-byte loads where `vec`, else element loads.
__device__ __forceinline__ void load8(float (&x)[8], const float* s, int valid, bool vec) {
  if (vec && valid == 8) {
    const float4 u = *reinterpret_cast<const float4*>(s);
    const float4 w = *reinterpret_cast<const float4*>(s + 4);
    x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
    x[4] = w.x, x[5] = w.y, x[6] = w.z, x[7] = w.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = e < valid ? s[e] : 0.0f;
  }
}

__device__ __forceinline__ void load8(float (&x)[8], const bf16* s, int valid, bool vec) {
  if (vec && valid == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(s);
    const bf16* e8 = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(e8[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = e < valid ? __bfloat162float(s[e]) : 0.0f;
  }
}

// The partial of (slot b, split s, head h): the unnormalised output row
// at ws[p * r], (max, sum) at ws[n_part * r + 2 p], p = (b * splits + s)
// * H + h, n_part = B * splits * H.
//
// DV: output columns a warp takes in PV (r <= 4 DV).  TK = 64 keys a tile
// (16 a warp, two n-tiles) up to DV 128, 32 (8 a warp) at DV 256, where
// the Q planes alone take half the shared memory.  QR: q_rope's type.
template <int DV, typename QR>
__global__ void __launch_bounds__(MMA_THREADS, 1)
paged_decode_mla_mma_kernel(const float* __restrict__ q_abs, const QR* __restrict__ q_rope,
                            const bf16* __restrict__ cp, const bf16* __restrict__ rp,
                            const int32_t* __restrict__ bt, const int32_t* __restrict__ pos,
                            float* __restrict__ ws, int H, int r, int dr, int page, int nb,
                            int n_pages, int pps, int splits, int stages, float scale,
                            int vec_q, int vec_qr, int vec_kv) {
  static_assert(DV % 16 == 0, "tile shape");
  constexpr int NT = DV <= 128 ? 2 : 1;   // 8-key n-tiles a warp takes of each tile
  constexpr int TK = 4 * 8 * NT;          // keys a tile
  constexpr int LT = 8;                   // threads a key row when copying a tile
  constexpr int LR = MMA_THREADS / LT;    // rows a copy round
  constexpr int ROUNDS = TK / LR;
  constexpr bool QR_F32 = sizeof(QR) == 4;
  constexpr int QR_PLANES = QR_F32 ? 3 : 1;
  constexpr int SCS = TK + SC_PAD;        // score row stride (f32)
  constexpr int PV_GROUP = DV / 16 < 8 ? DV / 16 : 8;   // 16-column chunks a PV round
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rp16 = (r + 15) / 16 * 16;
  const int dr16 = (dr + 15) / 16 * 16;
  const int W = rp16 + dr16 + PAD;        // Q and tile row stride (bf16)
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);             // 3 planes of MMA_ROWS x W
  bf16* t_s = q_s + 3 * MMA_ROWS * W;                        // stages x TK x W
  float* sc_s = reinterpret_cast<float*>(t_s + stages * TK * W);   // MMA_ROWS x SCS

  const int row_ctas = (H + MMA_ROWS - 1) / MMA_ROWS;
  const int s = blockIdx.y;
  const int b = blockIdx.x / row_ctas;
  const int h0 = (blockIdx.x - b * row_ctas) * MMA_ROWS;
  const int k_lo = s * pps * page;
  const int32_t* bt_row = bt + (long long)b * nb;
  // A tile is copied in rounds of LR key rows, LT threads a row: row jr
  // of each round, every LT-th chunk of 8 of its [c_kv ; k_rope] row, so
  // a warp's copies cover 4 rows x 128 contiguous bytes.  Each row is
  // found through the block table once.  The pages of this thread's rows
  // in the first tile are read before pos, so the loads overlap.
  const int jr = threadIdx.x / LT;
  const int lc = threadIdx.x % LT;
  // The pages of this thread's rows in tile i (indices clipped to the table).
  auto pages_of = [&](int i, int (&pg)[ROUNDS]) {
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u)
      pg[u] = bt_row[min((k_lo + i * TK + u * LR + jr) / page, nb - 1)];
  };
  int pg0[ROUNDS], pg_next[ROUNDS];
  pages_of(0, pg0);
  const int last = min(max(pos[b], 0), nb * page - 1);   // keys 0..last attended
  if (k_lo > last) return;                 // wholly past pos[b]: the merge skips it
  const int k_end = (int)min((long long)k_lo + (long long)pps * page, (long long)last + 1);
  const int n_tiles = (k_end - k_lo + TK - 1) / TK;

  // Rows past the split's end are zero; a round wholly past it is not
  // copied (no warp reads its rows: scores and PV stop at the last live
  // 16-key group).
  auto load_tile = [&](int i, const int (&pg)[ROUNDS]) {
#pragma unroll
    for (int u = 0; u < ROUNDS; ++u) {
      const int key = k_lo + i * TK + u * LR + jr;
      if (key - jr >= k_end) break;
      const bool live = key < k_end;
      const bf16 *cr = cp, *rr = rp;
      if (live) {
        const long long row = (long long)min(max(pg[u], 0), n_pages - 1) * page + key % page;
        cr = cp + row * r;
        rr = rp + row * dr;
      }
      bf16* d = t_s + ((stages == 2 ? (i & 1) : 0) * TK + u * LR + jr) * W;
      for (int d0 = lc * 8; d0 < rp16; d0 += LT * 8)
        repro::copy_chunk(d + d0, cr + d0, cp, live ? max(0, min(8, r - d0)) : 0, vec_kv);
      for (int d0 = lc * 8; d0 < dr16; d0 += LT * 8)
        repro::copy_chunk(d + rp16 + d0, rr + d0, rp, live ? max(0, min(8, dr - d0)) : 0,
                          vec_kv);
    }
    repro::cp_commit();
  };
  if (n_tiles > 1) pages_of(1, pg_next);

  // Q: three planes of [q_abs ; q_rope] a row; rows past H and columns
  // past r / dr zero.  q_abs comes in raw through cp.async (all of it in
  // flight at once) into the ring's last stage, which tile 1 needs only
  // later: with two stages, tile 0 streams into stage 0 meanwhile, also
  // while Q is cut; with one, tile 0 follows.  q_rope (a chunk of 8 a
  // thread at dr 64) is loaded into registers and cut there.  A bf16
  // q_rope is exact in plane 0.
  auto store_planes = [&](const float (&x)[8], int dst) {
    uint32_t w[3][4];
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      bf16 lo[3], hi[3];
      split3(x[e], lo);
      split3(x[e + 1], hi);
#pragma unroll
      for (int pl = 0; pl < 3; ++pl) w[pl][e / 2] = pack2(lo[pl], hi[pl]);
    }
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
      *reinterpret_cast<uint4*>(q_s + pl * MMA_ROWS * W + dst) =
          make_uint4(w[pl][0], w[pl][1], w[pl][2], w[pl][3]);
  };
  float* q_raw = reinterpret_cast<float*>(t_s + (stages - 1) * TK * W);   // MMA_ROWS x rp16
  const int cq = rp16 / 4;                 // chunks of 4 floats a q_abs row
  for (int i = threadIdx.x; i < MMA_ROWS * cq; i += MMA_THREADS) {
    const int row = i / cq;
    const int d0 = (i - row * cq) * 4;
    const int valid = h0 + row < H ? max(0, min(4, r - d0)) : 0;
    const float* src = q_abs + ((long long)b * H + h0 + row) * r + d0;
    float* dst = q_raw + row * rp16 + d0;
    if (vec_q) {
      repro::cp16(dst, valid ? src : q_abs, 4 * valid);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        repro::cp4(dst + e, e < valid ? src + e : q_abs, e < valid ? 4 : 0);
    }
  }
  repro::cp_commit();
  if (stages == 2) load_tile(0, pg0);      // its own group, after Q's
  const int cqr = dr16 / 8;
  for (int i = threadIdx.x; i < MMA_ROWS * cqr; i += MMA_THREADS) {
    const int row = i / cqr;
    const int e0 = (i - row * cqr) * 8;
    float x[8];
    load8(x, q_rope + ((long long)b * H + h0 + row) * dr + e0,
          h0 + row < H ? max(0, min(8, dr - e0)) : 0, vec_qr);
    store_planes(x, row * W + rp16 + e0);
  }
  if (stages == 2) {
    repro::cp_wait<1>();                   // Q in place; tile 0 may still stream
  } else {
    repro::cp_wait<0>();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MMA_ROWS * rp16 / 8; i += MMA_THREADS) {
    const int row = i / (rp16 / 8);
    const int d0 = (i - row * (rp16 / 8)) * 8;
    const float4 u = *reinterpret_cast<const float4*>(q_raw + row * rp16 + d0);
    const float4 v = *reinterpret_cast<const float4*>(q_raw + row * rp16 + d0 + 4);
    const float x[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
    store_planes(x, row * W + d0);
  }
  __syncthreads();                         // q_raw is read: its stage may take a tile
  if (stages == 1) load_tile(0, pg0);

  // This thread's rows (g and g + 8) and key / column pairs (2 qd + {0, 1}
  // of each 8-wide n-tile); the warp's keys are c0 .. c0 + 8 NT - 1 of
  // each tile, its output columns col0 .. col0 + DV - 1.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int c0 = warp * 8 * NT;
  const int col0 = warp * DV;
  const int a_off = (lane & 15) * W + (lane >> 4) * 8;
  const int k_off = NT == 2
      ? (c0 + (lane & 7) + ((lane >> 4) << 3)) * W + ((lane >> 3) & 1) * 8
      : (c0 + (lane & 7)) * W + ((lane >> 3) & 1) * 8;
  const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * W + (lane >> 4) * 8;

  float o[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;   // running max of rows g, g + 8
  float l0 = 0.0f, l1 = 0.0f;             // this thread's share of their sums

  for (int i = 0; i < n_tiles; ++i) {
    if (stages == 2 && i + 1 < n_tiles) {
      load_tile(i + 1, pg_next);
      if (i + 2 < n_tiles) pages_of(i + 2, pg_next);
      repro::cp_wait<1>();
    } else {
      repro::cp_wait<0>();
    }
    __syncthreads();                       // tile i in place
    const int n = min(TK, k_end - k_lo - i * TK);   // live keys of this tile
    const bf16* tb = t_s + (stages == 2 ? (i & 1) : 0) * TK * W;

    // Scores of the warp's keys; rows past the split's end at -inf.
    float sc[NT][4];
    if (c0 < n) {
      float acc[3][NT][4];
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
#pragma unroll
        for (int t = 0; t < NT; ++t)
          acc[pl][t][0] = acc[pl][t][1] = acc[pl][t][2] = acc[pl][t][3] = 0.0f;
      // The fragments of k-step kk (the warp's keys, each plane's Q), then
      // its MMAs.  ldmatrix and mma.sync are volatile asm and issue in
      // program order, so k-steps go in pairs, both loaded before either
      // multiplies: the loads' latency is paid once a pair.
      struct Frags {
        uint32_t a[3][4], b[4];
      };
      auto load = [&](Frags& f, int kk, int planes) {
        if constexpr (NT == 2) {
          repro::ldmatrix_x4(f.b, tb + k_off + kk);
        } else {
          uint32_t b2[2];
          ldmatrix_x2(b2, tb + k_off + kk);
          f.b[0] = b2[0], f.b[1] = b2[1];
        }
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          if (pl < planes) repro::ldmatrix_x4(f.a[pl], q_s + pl * MMA_ROWS * W + a_off + kk);
      };
      auto mma = [&](const Frags& f, int planes) {
#pragma unroll
        for (int pl = 0; pl < 3; ++pl)
          if (pl < planes)
#pragma unroll
            for (int t = 0; t < NT; ++t)
              repro::mma_bf16(acc[pl][t], f.a[pl], f.b[2 * t], f.b[2 * t + 1]);
      };
      auto walk = [&](int k0, int k1, int planes) {
        int kk = k0;
        for (; kk + 16 < k1; kk += 32) {
          Frags f0, f1;
          load(f0, kk, planes);
          load(f1, kk + 16, planes);
          mma(f0, planes);
          mma(f1, planes);
        }
        if (kk < k1) {
          Frags f0;
          load(f0, kk, planes);
          mma(f0, planes);
        }
      };
      walk(0, rp16, 3);
      walk(rp16, rp16 + dr16, QR_PLANES);
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = ((acc[2][t][e] + acc[1][t][e]) + acc[0][t][e]) * scale;
          sc[t][e] = c0 + t * 8 + 2 * qd + (e & 1) < n ? v : -INFINITY;
        }
    } else {
#pragma unroll
      for (int t = 0; t < NT; ++t) sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = -INFINITY;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      float* p0 = sc_s + g * SCS + c0 + t * 8 + 2 * qd;
      *reinterpret_cast<float2*>(p0) = make_float2(sc[t][0], sc[t][1]);
      *reinterpret_cast<float2*>(p0 + 8 * SCS) = make_float2(sc[t][2], sc[t][3]);
    }
    __syncthreads();                       // the 16 x TK score block in place

    // The CTA's softmax step, taken alike by every warp: this thread's
    // scores of rows g and g + 8 at keys 16 kp + 8 hf + 2 qd + {0, 1},
    // in the A-operand layout of PV's k-step kp.  Key 0 of the tile is
    // live, so the max is finite.
    float v0[TK / 4], v1[TK / 4];
#pragma unroll
    for (int kp = 0; kp < TK / 16; ++kp)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float* p0 = sc_s + g * SCS + kp * 16 + hf * 8 + 2 * qd;
        const float2 x = *reinterpret_cast<const float2*>(p0);
        const float2 y = *reinterpret_cast<const float2*>(p0 + 8 * SCS);
        v0[kp * 4 + hf * 2] = x.x, v0[kp * 4 + hf * 2 + 1] = x.y;
        v1[kp * 4 + hf * 2] = y.x, v1[kp * 4 + hf * 2 + 1] = y.y;
      }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int k = 0; k < TK / 4; ++k) {
      mx0 = fmaxf(mx0, v0[k]);
      mx1 = fmaxf(mx1, v1[k]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float al0 = expf(m0 - mx0);      // 0 on the first tile
    const float al1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int nn = 0; nn < DV / 8; ++nn) {
      o[nn][0] *= al0;
      o[nn][1] *= al0;
      o[nn][2] *= al1;
      o[nn][3] *= al1;
    }
#pragma unroll
    for (int kp = 0; kp < TK / 16; ++kp) {
      if (kp * 16 >= n) break;             // the rest of the tile is past the split
      // The weights of k-step kp, unnormalised, cut into three exact
      // planes: a[pl] is plane pl in the A layout (rows g / g + 8, keys
      // 2 qd + {0, 1} and 8 + 2 qd + {0, 1}).
      uint32_t a[3][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int k = kp * 4 + hf * 2;
        const float e0 = expf(v0[k] - m0), e1 = expf(v0[k + 1] - m0);
        const float e2 = expf(v1[k] - m1), e3 = expf(v1[k + 1] - m1);
        l0 += e0 + e1;
        l1 += e2 + e3;
        bf16 p0[3], p1[3], p2[3], p3[3];
        split3(e0, p0);
        split3(e1, p1);
        split3(e2, p2);
        split3(e3, p3);
#pragma unroll
        for (int pl = 0; pl < 3; ++pl) {
          a[pl][2 * hf] = pack2(p0[pl], p1[pl]);
          a[pl][2 * hf + 1] = pack2(p2[pl], p3[pl]);
        }
      }
      // The tile's c_kv columns of the warp, PV_GROUP 16-column chunks at
      // a time, all loaded before the MMAs, which go plane by plane so
      // that consecutive MMAs write different accumulators.
      const bf16* vb = tb + kp * 16 * W + v_off + col0;
#pragma unroll
      for (int d0 = 0; d0 < DV / 16; d0 += PV_GROUP) {
        uint32_t bv[PV_GROUP][4];
#pragma unroll
        for (int dp = 0; dp < PV_GROUP; ++dp)
          if (col0 + (d0 + dp) * 16 < rp16) repro::ldmatrix_x4_trans(bv[dp], vb + (d0 + dp) * 16);
#pragma unroll
        for (int pl = 2; pl >= 0; --pl)
#pragma unroll
          for (int dp = 0; dp < PV_GROUP; ++dp)
            if (col0 + (d0 + dp) * 16 < rp16) {
              repro::mma_bf16(o[2 * (d0 + dp)], a[pl], bv[dp][0], bv[dp][1]);
              repro::mma_bf16(o[2 * (d0 + dp) + 1], a[pl], bv[dp][2], bv[dp][3]);
            }
      }
    }
    __syncthreads();                       // the ring stage and the score block are free
    if (stages == 1 && i + 1 < n_tiles) {
      load_tile(i + 1, pg_next);
      if (i + 2 < n_tiles) pages_of(i + 2, pg_next);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const long long n_part = (long long)gridDim.x / row_ctas * splits * H;   // B * splits * H
  const long long pb = ((long long)b * splits + s) * H + h0;  // the partial of head h0
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = g + half * 8;
    if (h0 + row >= H) continue;
    float* w = ws + (pb + row) * r;
#pragma unroll
    for (int nn = 0; nn < DV / 8; ++nn) {
      const int col = col0 + nn * 8 + 2 * qd;
      const float x = o[nn][2 * half], y = o[nn][2 * half + 1];
      if (col + 1 < r && (r & 1) == 0) {
        *reinterpret_cast<float2*>(w + col) = make_float2(x, y);
      } else {
        if (col < r) w[col] = x;
        if (col + 1 < r) w[col + 1] = y;
      }
    }
    if (warp == 0 && qd == 0) {
      ws[n_part * r + 2 * (pb + row)] = half ? m1 : m0;
      ws[n_part * r + 2 * (pb + row) + 1] = half ? l1 : l0;
    }
  }
}

constexpr int MERGE_THREADS = 128;
constexpr int MERGE_PER = 1024 / MERGE_THREADS;   // r <= 1024

// out[b, 0, h] from the partials of the live splits of slot b.
__global__ void __launch_bounds__(MERGE_THREADS)
paged_decode_mla_merge_kernel(const float* __restrict__ ws, const int32_t* __restrict__ pos,
                              float* __restrict__ out, int B, int H, int r, int page, int nb,
                              int pps, int splits) {
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const long long n_part = (long long)B * splits * H;
  const long long p0 = (long long)b * splits * H + h;
  const float* ml = ws + n_part * r;
  // Split 0 is always live: read it before pos, then fold in the others
  // by their maxima and sums.
  float mx = ml[2 * p0], sum = ml[2 * p0 + 1];
  float acc[MERGE_PER];
#pragma unroll
  for (int k = 0; k < MERGE_PER; ++k) {
    const int d = threadIdx.x + k * MERGE_THREADS;
    acc[k] = d < r ? ws[p0 * r + d] : 0.0f;
  }
  const int last = min(max(pos[b], 0), nb * page - 1);
  const int live = last / (pps * page) + 1;
#pragma unroll 4
  for (int s = 1; s < live; ++s) {
    const long long p = p0 + (long long)s * H;
    const float m = ml[2 * p];
    const float mn = fmaxf(mx, m);
    const float f0 = expf(mx - mn), f1 = expf(m - mn);
    sum = sum * f0 + ml[2 * p + 1] * f1;
#pragma unroll
    for (int k = 0; k < MERGE_PER; ++k) {
      const int d = threadIdx.x + k * MERGE_THREADS;
      if (d < r) acc[k] = acc[k] * f0 + ws[p * r + d] * f1;
    }
    mx = mn;
  }
  float* o = out + ((long long)b * H + h) * r;
#pragma unroll
  for (int k = 0; k < MERGE_PER; ++k) {
    const int d = threadIdx.x + k * MERGE_THREADS;
    if (d < r) o[d] = acc[k] / sum;
  }
}

// Shared memory of the split walk: the Q planes, `stages` tiles of tk key
// rows, the score block (paged_attention.mla_decode_plan computes the same).
size_t mma_smem(int r, int dr, int tk, int stages) {
  const size_t w = (size_t)(r + 15) / 16 * 16 + (size_t)(dr + 15) / 16 * 16 + PAD;
  return sizeof(bf16) * w * (3 * MMA_ROWS + (size_t)stages * tk) +
         sizeof(float) * MMA_ROWS * (size_t)(tk + SC_PAD);
}

template <int DV, typename QR>
int launch_mma(const float* q_abs, const void* q_rope, const void* cp, const void* rp,
               const int32_t* bt, const int32_t* pos, float* ws, float* out, int B, int H,
               int r, int dr, int page, int nb, int n_pages, int pps, int tk, int stages,
               float scale, cudaStream_t stream) {
  constexpr int TK = DV <= 128 ? 64 : 32;
  if (tk != TK || (stages != 1 && stages != 2)) return (int)cudaErrorInvalidValue;
  const size_t smem = mma_smem(r, dr, tk, stages);
  auto kernel = paged_decode_mla_mma_kernel<DV, QR>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bool a16 = r % 8 == 0 && dr % 8 == 0, a4 = r % 2 == 0 && dr % 2 == 0;
  const void* kv[2] = {cp, rp};
  for (const void* p : kv) {
    a16 = a16 && repro::aligned(p, 16);
    a4 = a4 && repro::aligned(p, 4);
  }
  const int vec_kv = a16 ? 16 : (a4 ? 4 : 2);
  const int vec_q = r % 4 == 0 && repro::aligned(q_abs, 16);
  const int vec_qr = dr % (16 / (int)sizeof(QR)) == 0 && repro::aligned(q_rope, 16);
  const int splits = (nb + pps - 1) / pps;
  const long long row_ctas = (H + MMA_ROWS - 1) / MMA_ROWS;
  if (splits > 65535 || row_ctas * B > 0x7fffffffLL || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)(row_ctas * B), (unsigned)splits), MMA_THREADS, smem, stream>>>(
      q_abs, static_cast<const QR*>(q_rope), static_cast<const bf16*>(cp),
      static_cast<const bf16*>(rp), bt, pos, ws, H, r, dr, page, nb, n_pages, pps, splits,
      stages, scale, vec_q, vec_qr, vec_kv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_mla_merge_kernel<<<(unsigned)(B * H), MERGE_THREADS, 0, stream>>>(
      ws, pos, out, B, H, r, page, nb, pps, splits);
  return (int)cudaGetLastError();
}

template <typename QR>
int launch_mma_rank(const float* q_abs, const void* q_rope, const void* cp, const void* rp,
                    const int32_t* bt, const int32_t* pos, float* ws, float* out, int B, int H,
                    int r, int dr, int page, int nb, int n_pages, int pps, int tk, int stages,
                    float scale, cudaStream_t stream) {
  if (r <= 4 * 64)
    return launch_mma<64, QR>(q_abs, q_rope, cp, rp, bt, pos, ws, out, B, H, r, dr, page, nb,
                              n_pages, pps, tk, stages, scale, stream);
  if (r <= 4 * 128)
    return launch_mma<128, QR>(q_abs, q_rope, cp, rp, bt, pos, ws, out, B, H, r, dr, page, nb,
                               n_pages, pps, tk, stages, scale, stream);
  return launch_mma<256, QR>(q_abs, q_rope, cp, rp, bt, pos, ws, out, B, H, r, dr, page, nb,
                             n_pages, pps, tk, stages, scale, stream);
}

// ---- CUDA-core kernel (f32 pages) -----------------------------------------

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
template <typename TQR, int RL>
__global__ void __launch_bounds__(THREADS)
paged_decode_mla_kernel(const float* __restrict__ q_abs, const TQR* __restrict__ q_rope,
                        const float* __restrict__ cp, const float* __restrict__ rp,
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
      const long long src =
          (long long)min(max(bt_row[key / page], 0), n_pages - 1) * page + key % page;
      for (int d = lane; d < r; d += 32) c_s[j * RS + d] = cp[src * r + d];
      for (int d = lane; d < dr; d += 32) k_s[j * DRS + d] = rp[src * dr + d];
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

template <typename TQR, int RL>
int launch(const float* q_abs, const void* q_rope, const void* cp, const void* rp,
           const int32_t* bt, const int32_t* pos, float* out, int B, int H, int r, int dr,
           int page, int nb, int n_pages, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)TN * (RL * 32 + DRS) + (size_t)HB * TN);
  auto kernel = paged_decode_mla_kernel<TQR, RL>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, (H + HB - 1) / HB), THREADS, smem, stream>>>(
      q_abs, static_cast<const TQR*>(q_rope), static_cast<const float*>(cp),
      static_cast<const float*>(rp), bt, pos, out, H, r, dr, page, nb, n_pages, scale);
  return (int)cudaGetLastError();
}

template <typename TQR>
int launch_rank(const float* q_abs, const void* q_rope, const void* cp, const void* rp,
                const int32_t* bt, const int32_t* pos, float* out, int B, int H, int r, int dr,
                int page, int nb, int n_pages, float scale, cudaStream_t stream) {
  if (r <= 16 * 32)
    return launch<TQR, 16>(q_abs, q_rope, cp, rp, bt, pos, out, B, H, r, dr, page, nb, n_pages,
                           scale, stream);
  return launch<TQR, 32>(q_abs, q_rope, cp, rp, bt, pos, out, B, H, r, dr, page, nb, n_pages,
                         scale, stream);
}

}  // namespace

// bf16 pages: the split walk, then the merge.  ws holds B * splits * H *
// (r + 2) floats, splits = ceil(nb / pps); tk and stages are the tile's
// keys and ring depth from paged_attention.mla_decode_plan (refused
// unless they fit this kernel).
REPRO_EXPORT int paged_decode_mla_mma_launch(const void* q_abs, const void* q_rope,
                                             const void* cp, const void* rp, const int32_t* bt,
                                             const int32_t* pos, float* ws, float* out, int B,
                                             int H, int r, int dr, int page, int nb,
                                             int n_pages, int pps, int tk, int stages,
                                             float scale, int qr_bf16, int device,
                                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0) return 0;
  if (r < 1 || r > 1024 || dr < 1 || dr > 128 || nb < 1 || page < 1 || pps < 1 ||
      (long long)nb * page > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* qa = static_cast<const float*>(q_abs);
  if (qr_bf16)
    return launch_mma_rank<bf16>(qa, q_rope, cp, rp, bt, pos, ws, out, B, H, r, dr, page, nb,
                                 n_pages, pps, tk, stages, scale, s);
  return launch_mma_rank<float>(qa, q_rope, cp, rp, bt, pos, ws, out, B, H, r, dr, page, nb,
                                n_pages, pps, tk, stages, scale, s);
}

// f32 pages: the CUDA-core kernel (bf16 pages take
// paged_decode_mla_mma_launch).
REPRO_EXPORT int paged_decode_mla_launch(const void* q_abs, const void* q_rope, const void* cp,
                                         const void* rp, const int32_t* bt,
                                         const int32_t* pos, float* out, int B, int H, int r,
                                         int dr, int page, int nb, int n_pages, float scale,
                                         int qr_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || H == 0) return 0;
  if (r < 1 || r > 32 * 32 || dr < 1 || dr > DRL * 32 || nb < 1 || page < 1 ||
      (H + HB - 1) / HB > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* qa = static_cast<const float*>(q_abs);
  if (qr_bf16)
    return launch_rank<__nv_bfloat16>(qa, q_rope, cp, rp, bt, pos, out, B, H, r, dr, page, nb,
                                      n_pages, scale, s);
  return launch_rank<float>(qa, q_rope, cp, rp, bt, pos, out, B, H, r, dr, page, nb, n_pages,
                            scale, s);
}

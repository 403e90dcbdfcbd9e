// K4: paged GQA decode attention through a block table.
//
// Replaces repro/kernels/paged_attention.py:paged_decode_gqa_pallas.
//
//   q (B, 1, H, hd), pages k (n_pages, page, Hk, hd) / v (.., hdv),
//   block table bt (B, nb) int32, pos (B,) int32
//   out[b, 0, h*G + g] = softmax_s(q . k_s / sqrt(hd), s <= pos[b]) @ v
//
// where key s of slot b lives in page bt[b, s / page], row s % page, and
// G = H / Hk query heads share KV head h.  q and the pages are each f32
// or bf16; scores, softmax and the output are f32.  As in the plain
// version, q * (1/sqrt(hd)) is rounded to q's type and the softmax
// weights to the pages' type before the PV product.
//
// What bounds it on an H100: bytes, and at the serve's size the latency
// of a short walk.  At qwen2.5-3b's decode step (4 slots at positions
// ~400, 2 KV heads of 128, G = 8) the live K/V rows are ~1.6 MB, 0.0005
// ms at 3.35 TB/s, and the products 0.013 GFLOP, nothing on the tensor
// cores.  One CTA per (slot, KV head) gives 8 CTAs on 132 SMs, each
// walking ~13 tiles in turn with one tile in flight: the card then waits
// on a chain of load latencies, not on its memory.
//
// bf16 q and pages (every serve launch) take two launches, the split
// walk and its merge; the wrapper chooses by type alone before launching:
//
// paged_decode_gqa_mma_kernel: the walk split across CTAs
// (flash-decoding).
//   - Grid (splits x B, Hk x ceil(G / 16)).  Split s of slot b takes the
//     keys of pages [s * pps, (s + 1) * pps), clipped at pos[b]; a CTA
//     whose run starts past pos[b] returns at once.  The wrapper sizes
//     pps from the shapes alone (about two CTAs an SM, at least one
//     64-key tile a split): reading pos on the host would sync.
//   - The A tile is the G query heads of KV head h, padded to 16 rows
//     (G > 16 takes more CTAs, one 16-row tile each), staged once as
//     bf16(q * scale).  K and V tiles of 64 keys go through a two-stage
//     cp.async ring, each key's row found through the block table once
//     and copied as 16-byte chunks (4-byte or element copies where rows
//     are not 16-byte aligned); head dims are zero-padded to 16.
//   - Each of the 4 warps takes 16 keys of every tile: S = Q K^T by
//     ldmatrix -> mma.sync m16n8k16 bf16 -> f32, an online softmax in
//     registers (running max and sum per row), the unnormalised weights
//     rounded to bf16 and used from registers as PV's A operand, V read
//     by ldmatrix.trans.  The warps' (max, sum, output) are merged in
//     shared memory and the CTA writes one partial per query head to a
//     float32 workspace the wrapper allocates.
// paged_decode_gqa_merge_kernel: one CTA per (slot, query head) reads
//   pos[b] to know how many splits are live and combines their partials
//   by their maxima and sums into out.  Two launches rather than one
//   whose last CTA merges: the last-CTA scheme needs a counter zeroed
//   before every call (a memset launch, or state kept across calls).
//
// paged_decode_gqa_kernel (the pairs with an f32 operand, held at 1e-5,
// which bf16 products cannot meet): one CTA per (slot b, KV head h); its
// G query heads share every K/V row it loads.  The CTA walks the keys
// 0..pos[b] in tiles of TN rows, each row read through the block table
// and staged in shared memory as f32 with a padded stride (hd + 1), and
// keeps an online softmax (running max and sum per head, in f32).
//
// Keys past pos[b] contribute exact zeros to the reference's softmax,
// so skipping them computes the same function.
#include <math.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- tensor-core split walk (bf16 q and pages) ----------------------------

constexpr int MMA_THREADS = 128;   // 4 warps
constexpr int MMA_KEYS = 64;       // keys a tile, 16 a warp
constexpr int MMA_ROWS = 16;       // query heads a CTA: one m16 row tile
constexpr int PAD = 8;             // bf16 past each shared-memory row
static_assert(MMA_THREADS == 2 * MMA_KEYS, "two threads a key row");

// The partials of (slot b, KV head h, split s, query head g): the
// unnormalised output row at ws[p * hdv], (max, sum) at ws[n_part * hdv +
// 2 p], p = ((b * Hk + h) * splits + s) * G + g.
template <int DV>
__global__ void __launch_bounds__(MMA_THREADS)
paged_decode_gqa_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kp,
                            const bf16* __restrict__ vp, const int32_t* __restrict__ bt,
                            const int32_t* __restrict__ pos, float* __restrict__ ws, int H,
                            int Hk, int hd, int hdv, int page, int nb, int n_pages, int pps,
                            int splits, int dkp, float scale, int vec_q, int vec_kv) {
  static_assert(DV % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = dkp + PAD;                 // Q and K row stride (bf16)
  constexpr int VS = DV + PAD;              // V row stride
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);     // MMA_ROWS x ks
  bf16* k_s = q_s + MMA_ROWS * ks;                   // 2 stages of MMA_KEYS x ks
  bf16* v_s = k_s + 2 * MMA_KEYS * ks;               // 2 stages of MMA_KEYS x VS

  const int G = H / Hk;
  const int row_tiles = (G + MMA_ROWS - 1) / MMA_ROWS;
  const int s = blockIdx.x % splits;
  const int b = blockIdx.x / splits;
  const int h = blockIdx.y / row_tiles;
  const int g0 = (blockIdx.y - h * row_tiles) * MMA_ROWS;
  const int k_lo = s * pps * page;
  const int32_t* bt_row = bt + (long long)b * nb;
  // Two threads a key row of each tile: row j = tid / 2 takes every other
  // chunk of 8 of its K and V rows, found through the block table once.
  // The page of this row's key in the first tile is read before pos
  // (index clipped to the table), so the two loads overlap.
  const int jr = threadIdx.x >> 1;
  const int pg0 = bt_row[min((k_lo + jr) / page, nb - 1)];
  const int last = min(max(pos[b], 0), nb * page - 1);   // keys 0..last attended
  if (k_lo > last) return;                 // wholly past pos[b]: the merge skips it
  const int k_end = (int)min((long long)k_lo + (long long)pps * page, (long long)last + 1);
  const int n_tiles = (k_end - k_lo + MMA_KEYS - 1) / MMA_KEYS;

  auto load_tile = [&](int i) {
    const int key = k_lo + i * MMA_KEYS + jr;
    const bool live = key < k_end;
    const bf16 *kr = kp, *vr = vp;
    if (live) {
      const long long pg = min(max(i == 0 ? pg0 : bt_row[key / page], 0), n_pages - 1);
      const long long row = (pg * page + key % page) * Hk + h;
      kr = kp + row * hd;
      vr = vp + row * hdv;
    }
    bf16* kd = k_s + ((i & 1) * MMA_KEYS + jr) * ks;
    bf16* vd = v_s + ((i & 1) * MMA_KEYS + jr) * VS;
    for (int d0 = (threadIdx.x & 1) * 8; d0 < dkp; d0 += 16)
      repro::copy_chunk(kd + d0, kr + d0, kp, live ? max(0, min(8, hd - d0)) : 0, vec_kv);
#pragma unroll
    for (int d0 = (threadIdx.x & 1) * 8; d0 < DV; d0 += 16)
      repro::copy_chunk(vd + d0, vr + d0, vp, live ? max(0, min(8, hdv - d0)) : 0, vec_kv);
    repro::cp_commit();
  };
  load_tile(0);

  // Q, scaled and rounded to bf16; rows past G and columns past hd zero.
  const int q_chunks = dkp / 8;
  for (int i = threadIdx.x; i < MMA_ROWS * q_chunks; i += MMA_THREADS) {
    const int r = i / q_chunks;
    const int d0 = (i - r * q_chunks) * 8;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = 0.0f;
    if (g0 + r < G && d0 < hd) {
      const bf16* src = q + ((long long)b * H + (long long)h * G + g0 + r) * hd + d0;
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
    *reinterpret_cast<uint4*>(q_s + r * ks + d0) = w;
  }

  // This thread's rows (lane / 4 and lane / 4 + 8) and key columns
  // (2 * (lane % 4) + {0, 1} of each 8-key n-tile); the warp's keys are
  // rows c0 .. c0 + 15 of each tile.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int c0 = warp * 16;
  const int a_off = (lane & 15) * ks + (lane >> 4) * 8;
  const int k_off = (c0 + (lane & 7) + ((lane >> 4) << 3)) * ks + ((lane >> 3) & 1) * 8;
  const int v_off = (c0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * VS + (lane >> 4) * 8;

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
    // Live keys of this tile; only the last tile is short, so a warp's
    // first key is live in every tile it takes, and its max is finite.
    const int n = min(MMA_KEYS, k_end - k_lo - i * MMA_KEYS);
    if (c0 < n) {
      const bf16* kb = k_s + (i & 1) * MMA_KEYS * ks;
      const bf16* vb = v_s + (i & 1) * MMA_KEYS * VS;
      float sc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      for (int kk = 0; kk < dkp; kk += 16) {
        uint32_t a[4], bk[4];
        repro::ldmatrix_x4(a, q_s + a_off + kk);
        repro::ldmatrix_x4(bk, kb + k_off + kk);
        repro::mma_bf16(sc[0], a, bk[0], bk[1]);
        repro::mma_bf16(sc[1], a, bk[2], bk[3]);
      }
      if (c0 + 16 > n) {
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + t * 8 + 2 * qd + (e & 1) >= n) sc[t][e] = -INFINITY;
      }
      float mx0 = fmaxf(m0, fmaxf(fmaxf(sc[0][0], sc[0][1]), fmaxf(sc[1][0], sc[1][1])));
      float mx1 = fmaxf(m1, fmaxf(fmaxf(sc[0][2], sc[0][3]), fmaxf(sc[1][2], sc[1][3])));
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float al0 = expf(m0 - mx0);    // 0 on the warp's first tile
      const float al1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      // The weights, unnormalised, rounded to bf16 as PV's A operand (the
      // accumulator layout of S's two n-tiles is the A layout of k16).
      uint32_t p[4];
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float e0 = expf(sc[t][0] - m0), e1 = expf(sc[t][1] - m0);
        const float e2 = expf(sc[t][2] - m1), e3 = expf(sc[t][3] - m1);
        sum0 += e0 + e1;
        sum1 += e2 + e3;
        p[2 * t] = repro::pack_bf16(e0, e1);
        p[2 * t + 1] = repro::pack_bf16(e2, e3);
      }
      l0 = l0 * al0 + sum0;
      l1 = l1 * al1 + sum1;
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t bv[4];
        repro::ldmatrix_x4_trans(bv, vb + v_off + dp * 16);
        o[2 * dp][0] *= al0;
        o[2 * dp][1] *= al0;
        o[2 * dp][2] *= al1;
        o[2 * dp][3] *= al1;
        o[2 * dp + 1][0] *= al0;
        o[2 * dp + 1][1] *= al0;
        o[2 * dp + 1][2] *= al1;
        o[2 * dp + 1][3] *= al1;
        repro::mma_bf16(o[2 * dp], p, bv[0], bv[1]);
        repro::mma_bf16(o[2 * dp + 1], p, bv[2], bv[3]);
      }
    }
    __syncthreads();                       // stage i & 1 is free for tile i + 2
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // Merge the 4 warps in shared memory (the ring is free).  A warp that
  // took no key holds (-inf, 0, 0) and gets weight 0; warp 0 always took
  // key k_lo, so the CTA's max is finite.
  float* ml_s = reinterpret_cast<float*>(smem_raw);   // 4 x 16 x (max, sum)
  float* f_s = ml_s + 4 * MMA_ROWS * 2;               // 16 x 4 weights of the warps
  float* o_s = f_s + MMA_ROWS * 4;                    // 4 x 16 x DV
  if (qd == 0) {
    ml_s[(warp * MMA_ROWS + g) * 2] = m0;
    ml_s[(warp * MMA_ROWS + g) * 2 + 1] = l0;
    ml_s[(warp * MMA_ROWS + g + 8) * 2] = m1;
    ml_s[(warp * MMA_ROWS + g + 8) * 2 + 1] = l1;
  }
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    float* r0 = o_s + (warp * MMA_ROWS + g) * DV + n * 8 + 2 * qd;
    *reinterpret_cast<float2*>(r0) = make_float2(o[n][0], o[n][1]);
    *reinterpret_cast<float2*>(r0 + 8 * DV) = make_float2(o[n][2], o[n][3]);
  }
  __syncthreads();
  const int rows = min(MMA_ROWS, G - g0);
  const long long p0 = (((long long)b * Hk + h) * splits + s) * G + g0;
  const long long n_part = (long long)gridDim.x * Hk * G;   // B * splits * Hk * G
  if (threadIdx.x < rows) {
    const int r = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, ml_s[(w * MMA_ROWS + r) * 2]);
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float f = expf(ml_s[(w * MMA_ROWS + r) * 2] - mx);
      f_s[r * 4 + w] = f;
      sum += ml_s[(w * MMA_ROWS + r) * 2 + 1] * f;
    }
    ws[n_part * hdv + 2 * (p0 + r)] = mx;
    ws[n_part * hdv + 2 * (p0 + r) + 1] = sum;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * hdv; i += MMA_THREADS) {
    const int r = i / hdv;
    const int d = i - r * hdv;
    float acc = 0.0f;
#pragma unroll
    for (int w = 0; w < 4; ++w) acc += o_s[(w * MMA_ROWS + r) * DV + d] * f_s[r * 4 + w];
    ws[(p0 + r) * hdv + d] = acc;
  }
}

constexpr int MERGE_THREADS = 128;

// out[b, 0, hq] from the partials of the live splits of (b, hq / G).
__global__ void __launch_bounds__(MERGE_THREADS)
paged_decode_gqa_merge_kernel(const float* __restrict__ ws, const int32_t* __restrict__ pos,
                              float* __restrict__ out, int B, int H, int Hk, int hdv, int page,
                              int nb, int pps, int splits) {
  const int b = blockIdx.x / H;
  const int hq = blockIdx.x - b * H;
  const int G = H / Hk;
  const long long n_part = (long long)B * splits * H;
  const long long p0 = ((long long)b * Hk + hq / G) * splits * G + hq % G;
  const float* ml = ws + n_part * hdv;
  constexpr int PER = 256 / MERGE_THREADS;   // hdv <= 256
  // Split 0 is always live: read it before pos, then fold in the others
  // by their maxima and sums.
  float mx = ml[2 * p0], sum = ml[2 * p0 + 1];
  float acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int d = threadIdx.x + k * MERGE_THREADS;
    acc[k] = d < hdv ? ws[p0 * hdv + d] : 0.0f;
  }
  const int last = min(max(pos[b], 0), nb * page - 1);
  const int live = last / (pps * page) + 1;
#pragma unroll 4
  for (int s = 1; s < live; ++s) {
    const long long p = p0 + (long long)s * G;
    const float m = ml[2 * p];
    const float mn = fmaxf(mx, m);
    const float f0 = expf(mx - mn), f1 = expf(m - mn);
    sum = sum * f0 + ml[2 * p + 1] * f1;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int d = threadIdx.x + k * MERGE_THREADS;
      if (d < hdv) acc[k] = acc[k] * f0 + ws[p * hdv + d] * f1;
    }
    mx = mn;
  }
  float* o = out + ((long long)b * H + hq) * hdv;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int d = threadIdx.x + k * MERGE_THREADS;
    if (d < hdv) o[d] = acc[k] / sum;
  }
}

template <int DV>
int launch_mma(const void* q, const void* kp, const void* vp, const int32_t* bt,
               const int32_t* pos, float* ws, float* out, int B, int H, int Hk, int hd, int hdv,
               int page, int nb, int n_pages, int pps, float scale, cudaStream_t stream) {
  const int dkp = (hd + 15) / 16 * 16;
  const size_t ring = sizeof(bf16) * ((size_t)(MMA_ROWS + 2 * MMA_KEYS) * (dkp + PAD) +
                                      2 * (size_t)MMA_KEYS * (DV + PAD));
  const size_t merge = sizeof(float) * (4 * MMA_ROWS * 2 + MMA_ROWS * 4 + 4 * MMA_ROWS * DV);
  const size_t smem = ring > merge ? ring : merge;
  auto kernel = paged_decode_gqa_mma_kernel<DV>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bool a16 = hd % 8 == 0 && hdv % 8 == 0, a4 = hd % 2 == 0 && hdv % 2 == 0;
  const void* kv[2] = {kp, vp};
  for (const void* p : kv) {
    a16 = a16 && repro::aligned(p, 16);
    a4 = a4 && repro::aligned(p, 4);
  }
  const int vec_kv = a16 ? 16 : (a4 ? 4 : 2);
  const int vec_q = hd % 8 == 0 && repro::aligned(q, 16);
  const int G = H / Hk;
  const int splits = (nb + pps - 1) / pps;
  const long long row_ctas = (long long)Hk * ((G + MMA_ROWS - 1) / MMA_ROWS);
  if (row_ctas > 65535 || (long long)splits * B > 0x7fffffffLL ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)(splits * B), (unsigned)row_ctas), MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kp), static_cast<const bf16*>(vp),
      bt, pos, ws, H, Hk, hd, hdv, page, nb, n_pages, pps, splits, dkp, scale, vec_q, vec_kv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_gqa_merge_kernel<<<(unsigned)(B * H), MERGE_THREADS, 0, stream>>>(
      ws, pos, out, B, H, Hk, hdv, page, nb, pps, splits);
  return (int)cudaGetLastError();
}

// ---- CUDA-core kernel (an f32 operand) ------------------------------------

constexpr int TN = 32;        // keys per tile: one per lane in the softmax step
constexpr int THREADS = 128;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
paged_decode_gqa_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kp,
                        const TKV* __restrict__ vp, const int32_t* __restrict__ bt,
                        const int32_t* __restrict__ pos, float* __restrict__ out,
                        int H, int Hk, int hd, int hdv, int page, int nb,
                        int n_pages, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = H / Hk;
  const int ks = hd + 1;
  const int vs = hdv + 1;
  float* q_s = smem;               // G * hd
  float* k_s = q_s + G * hd;       // TN * ks
  float* v_s = k_s + TN * ks;      // TN * vs
  float* p_s = v_s + TN * vs;      // G * TN: scores, then weights
  float* o_s = p_s + G * TN;       // G * hdv: unnormalised output
  float* m_s = o_s + G * hdv;      // G: running max
  float* l_s = m_s + G;            // G: running sum
  float* a_s = l_s + G;            // G: rescale of the current tile

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int last = min(max(pos[b], 0), nb * page - 1);   // keys 0..last attended
  const int32_t* bt_row = bt + (long long)b * nb;

  const TQ* q_b = q + ((long long)b * H + (long long)h * G) * hd;
  for (int i = tid; i < G * hd; i += THREADS)
    q_s[i] = repro::round_to<TQ>(repro::to_f32(q_b[i]) * scale);
  for (int i = tid; i < G * hdv; i += THREADS) o_s[i] = 0.0f;
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.0f;
  }
  __syncthreads();

  for (int t0 = 0; t0 <= last; t0 += TN) {
    const int n = min(TN, last - t0 + 1);   // live rows of this tile
    for (int i = tid; i < n * hd; i += THREADS) {
      const int j = i / hd;
      const int d = i - j * hd;
      const int key = t0 + j;
      const long long pg = min(bt_row[key / page], n_pages - 1);
      k_s[j * ks + d] = repro::to_f32(kp[((pg * page + key % page) * Hk + h) * hd + d]);
    }
    for (int i = tid; i < n * hdv; i += THREADS) {
      const int j = i / hdv;
      const int d = i - j * hdv;
      const int key = t0 + j;
      const long long pg = min(bt_row[key / page], n_pages - 1);
      v_s[j * vs + d] = repro::to_f32(vp[((pg * page + key % page) * Hk + h) * hdv + d]);
    }
    __syncthreads();

    for (int i = tid; i < G * TN; i += THREADS) {
      const int g = i / TN;
      const int j = i - g * TN;
      float s = -INFINITY;
      if (j < n) {
        const float* qr = q_s + g * hd;
        const float* kr = k_s + j * ks;
        float acc = 0.0f;
        for (int d = 0; d < hd; ++d) acc = fmaf(qr[d], kr[d], acc);
        s = acc;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // Online softmax, one warp per query head, one key per lane.  The
    // tile's first key (t0 <= last) is always live, so m stays finite.
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s = p_s[g * TN + lane];
      float mx = s;
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = s == -INFINITY ? 0.0f : expf(s - m_new);
      float sum = p;
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      p_s[g * TN + lane] = repro::round_to<TKV>(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);   // 0 on the first tile
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * hdv; i += THREADS) {
      const int g = i / hdv;
      const int d = i - g * hdv;
      const float* pr = p_s + g * TN;
      float acc = o_s[i] * a_s[g];
      for (int j = 0; j < n; ++j) acc = fmaf(pr[j], v_s[j * vs + d], acc);
      o_s[i] = acc;
    }
    __syncthreads();
  }

  float* o_b = out + ((long long)b * H + (long long)h * G) * hdv;
  for (int i = tid; i < G * hdv; i += THREADS) o_b[i] = o_s[i] / l_s[i / hdv];
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const int32_t* bt,
           const int32_t* pos, float* out, int B, int H, int Hk, int hd, int hdv,
           int page, int nb, int n_pages, float scale, cudaStream_t stream) {
  const int G = H / Hk;
  const size_t smem =
      sizeof(float) * ((size_t)G * hd + (size_t)TN * (hd + 1) + (size_t)TN * (hdv + 1) +
                       (size_t)G * TN + (size_t)G * hdv + 3 * (size_t)G);
  auto kernel = paged_decode_gqa_kernel<TQ, TKV>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, Hk), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp), static_cast<const TKV*>(vp),
      bt, pos, out, H, Hk, hd, hdv, page, nb, n_pages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q and pages: the split walk, then the merge.  ws holds B * H *
// splits * (hdv + 2) floats, splits = ceil(nb / pps).
REPRO_EXPORT int paged_decode_gqa_mma_launch(const void* q, const void* kp, const void* vp,
                                             const int32_t* bt, const int32_t* pos, float* ws,
                                             float* out, int B, int H, int Hk, int hd, int hdv,
                                             int page, int nb, int n_pages, int pps,
                                             float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  if (Hk < 1 || H % Hk != 0 || nb < 1 || page < 1 || pps < 1 || hd < 1 || hd > 256 ||
      hdv < 1 || hdv > 256 || (long long)nb * page > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (hdv <= 64)
    return launch_mma<64>(q, kp, vp, bt, pos, ws, out, B, H, Hk, hd, hdv, page, nb, n_pages, pps, scale, s);
  if (hdv <= 128)
    return launch_mma<128>(q, kp, vp, bt, pos, ws, out, B, H, Hk, hd, hdv, page, nb, n_pages, pps, scale, s);
  return launch_mma<256>(q, kp, vp, bt, pos, ws, out, B, H, Hk, hd, hdv, page, nb, n_pages, pps, scale, s);
}

// A pair with an f32 operand: the CUDA-core kernel (bf16 q and pages take
// paged_decode_gqa_mma_launch and are refused here).
REPRO_EXPORT int paged_decode_gqa_launch(const void* q, const void* kp, const void* vp,
                                         const int32_t* bt, const int32_t* pos, float* out,
                                         int B, int H, int Hk, int hd, int hdv, int page,
                                         int nb, int n_pages, float scale, int q_bf16,
                                         int kv_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  if (Hk > 65535 || H % Hk != 0 || nb < 1 || page < 1 || (q_bf16 && kv_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (q_bf16)
    return launch<bf16, float>(q, kp, vp, bt, pos, out, B, H, Hk, hd, hdv, page, nb, n_pages, scale, s);
  if (kv_bf16)
    return launch<float, bf16>(q, kp, vp, bt, pos, out, B, H, Hk, hd, hdv, page, nb, n_pages, scale, s);
  return launch<float, float>(q, kp, vp, bt, pos, out, B, H, Hk, hd, hdv, page, nb, n_pages, scale, s);
}

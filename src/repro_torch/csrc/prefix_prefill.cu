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
// What bounds it on an H100: on the serving path (a burst of up to 4
// prompt tails of <= 512 tokens over up to 1024 context rows, 16 heads
// of 128) the work is ~10 GFLOP of scores and PV, against ~10 MB of
// operands: operations, at the tensor-core rate a bound of ~0.01 ms.
// This first kernel runs them on CUDA cores in f32 (a wgmma version is
// later work).
//
// Design: one CTA per (tile of Tt tail queries, KV head h, row b); its
// R = Tt * G query rows (all G heads of h) share every K/V row it
// loads.  The TPU kernel copied the whole [ctx ; tail] into VMEM and ran
// one full masked softmax per tile; here the CTA walks only the context
// tiles that hold a column j < ctx_len[b], then only the tail tiles up
// to its own last query, with an online softmax (running max and sum per
// row, f32).  Fully masked columns contribute exact zeros to the
// reference's softmax, so skipping them computes the same function.
// The first tile a CTA reads (context column 0 when ctx_len > 0, else
// tail column 0) is live for every row, so each row's running max is
// finite from then on and zero-padded or ragged rows stay finite.
#include <math.h>

#include "common.cuh"

namespace {

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

REPRO_EXPORT int prefix_prefill_launch(const void* q, const void* kc, const void* vc,
                                       const void* kt, const void* vt,
                                       const int32_t* ctx_len, float* out, int B, int T,
                                       int L, int H, int Hk, int hd, int hdv, int Tt,
                                       float scale, int q_bf16, int kv_bf16, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0) return 0;
  if (B > 65535 || Hk > 65535 || H % Hk != 0 || Tt < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_bf16 && kv_bf16)
    return launch<bf16, bf16>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, Tt, scale, s);
  if (q_bf16)
    return launch<bf16, float>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, Tt, scale, s);
  if (kv_bf16)
    return launch<float, bf16>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, Tt, scale, s);
  return launch<float, float>(q, kc, vc, kt, vt, ctx_len, out, B, T, L, H, Hk, hd, hdv, Tt, scale, s);
}

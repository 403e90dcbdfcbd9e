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
// What bounds it on an H100: the launch.  On the serving path it runs
// once per layer per decode step at B = max_slots (4) and reads q, the
// live K/V rows (~2 MB at 480 tokens) and writes 64 KB: under a
// microsecond at 3.35 TB/s, against several microseconds of launch.
//
// Design: one CTA per (slot b, KV head h); its G query heads share every
// K/V row it loads.  The TPU kernel gathered all nb pages and ran one
// full masked softmax over them (to keep XLA's summation tree); here the
// CTA walks only the keys 0..pos[b] in tiles of TN rows, each row read
// through the block table, and keeps an online softmax (running max and
// sum per head, in f32).  Keys past pos[b] contribute exact zeros to the
// reference's softmax, so skipping them computes the same function.
// Rows are staged in shared memory as f32 with a padded stride (hd + 1),
// so the per-key dot products of a warp hit distinct banks.
#include <math.h>

#include "common.cuh"

namespace {

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

REPRO_EXPORT int paged_decode_gqa_launch(const void* q, const void* kp, const void* vp,
                                         const int32_t* bt, const int32_t* pos, float* out,
                                         int B, int H, int Hk, int hd, int hdv, int page,
                                         int nb, int n_pages, float scale, int q_bf16,
                                         int kv_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return 0;
  if (Hk > 65535 || H % Hk != 0 || nb < 1 || page < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (q_bf16 && kv_bf16)
    return launch<bf16, bf16>(q, kp, vp, bt, pos, out, B, H, Hk, hd, hdv, page, nb, n_pages, scale, s);
  if (q_bf16)
    return launch<bf16, float>(q, kp, vp, bt, pos, out, B, H, Hk, hd, hdv, page, nb, n_pages, scale, s);
  if (kv_bf16)
    return launch<float, bf16>(q, kp, vp, bt, pos, out, B, H, Hk, hd, hdv, page, nb, n_pages, scale, s);
  return launch<float, float>(q, kp, vp, bt, pos, out, B, H, Hk, hd, hdv, page, nb, n_pages, scale, s);
}

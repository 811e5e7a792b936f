// Training backward of flash attention: dq.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/flash_attention_bwd.py
// `_dq_kernel` (reached through `_flash_bwd_rule`, the VJP of
// `flash_attention_trainable`). It recomputes the probabilities from the
// forward's per-row log-sum-exp instead of storing them, by the Pallas
// kernels' formula:
//   p  = exp(q k^T * scale - lse)  where the mask holds, else 0
//   ds = p * (dO v^T - delta) * scale,   delta = rowsum(dO * O) (f32, given)
//   dq = ds k
// with bf16 operands and f32 accumulators: ds is rounded to bf16 before ds k,
// as the Pallas kernel casts it. The mask is key < kv_len and, when causal,
// key <= query index. The dk/dv half of the backward is kernel 6
// (flash_train_dkv_sm90.cu).
//
// What bounds it on the H100: at the train shape (B = 4, L = 2304, 16 q / 2
// kv heads, D = 128) it does three 64x64x128 products per tile pair over the
// same ~100 MB of operands as the forward, so it is tensor-core bound. The
// design keeps every intermediate out of device memory (S, dP and dS live in
// shared memory for one tile pair) and avoids cross-CTA reductions: one CTA
// per (batch, q head, 64-row q tile) loops over the K/V tiles up to the
// causal diagonal and ceil(kv_len / 64); its dq tile is accumulated in shared
// memory by that CTA alone. Each warp owns 16 query rows through all
// products, so the warps only meet at the tile loads.
#include "attention_tile.cuh"

namespace socio {

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dO;
  const float* lse;    // (B, H, Lq)
  const float* delta;  // (B, H, Lq)
  bf16* dq;
  const int* kv_lens;  // (B,)
  int Lq, Lk, H, Hkv, causal;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdob, sdot, sdoh;
  long long sdqb, sdqt, sdqh;
  float scale;
};

// Shared memory: two bf16 row tiles that stay (A0, A1: Q and dO), two that
// stream (B0, B1: K and V), the f32 score and dP tiles, the bf16 dS tile, the
// f32 dq accumulator and the per-row lse and delta. Offsets and 16-row steps
// are multiples of 32 bytes (WMMA).
template <int D>
struct BwdSmem {
  static constexpr size_t tile = size_t(kRows) * Ld<D>::qkv * 2;
  static constexpr size_t a0 = 0;
  static constexpr size_t a1 = a0 + tile;
  static constexpr size_t b0 = a1 + tile;
  static constexpr size_t b1 = b0 + tile;
  static constexpr size_t s = b1 + tile;                            // f32 [kRows][Ld::s]
  static constexpr size_t dp = s + size_t(kRows) * Ld<D>::s * 4;    // f32 [kRows][Ld::s]
  static constexpr size_t ds = dp + size_t(kRows) * Ld<D>::s * 4;   // bf16 [kRows][Ld::p]
  static constexpr size_t acc0 = ds + size_t(kRows) * Ld<D>::p * 2; // f32 [kRows][Ld::o]
  static constexpr size_t lse = acc0 + size_t(kRows) * Ld<D>::o * 4;  // f32 [kRows]
  static constexpr size_t delta = lse + kRows * 4;                  // f32 [kRows]
  static constexpr size_t bytes = delta + kRows * 4;
};

template <int D>
__device__ __forceinline__ void zero_acc(float* acc) {
  for (int i = threadIdx.x; i < kRows * Ld<D>::o; i += kThreads) acc[i] = 0.f;
}

// lse and delta of q rows q0 .. q0 + 63 of (batch, head) row bh; 0 past Lq
// (those rows are masked).
__device__ __forceinline__ void load_row_stats(const BwdArgs& a, long long bh, int q0,
                                               float* lse_s, float* delta_s) {
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    const int t = q0 + r;
    lse_s[r] = t < a.Lq ? a.lse[bh * a.Lq + t] : 0.f;
    delta_s[r] = t < a.Lq ? a.delta[bh * a.Lq + t] : 0.f;
  }
}

// acc row r (f32) -> bf16 at row_ptr(r) unless that is nullptr.
template <int D, typename RowPtr>
__device__ __forceinline__ void store_acc(const float* acc, RowPtr row_ptr) {
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    bf16* dst = row_ptr(r);
    if (dst != nullptr) dst[d] = __float2bfloat16(acc[r * Ld<D>::o + d]);
  }
}

// ----------------------------------------------------------------------- dq

template <int D>
__global__ void __launch_bounds__(kThreads) flash_train_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = BwdSmem<D>;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::a0);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L::a1);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::b0);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::b1);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  float* dPs = reinterpret_cast<float*>(smem + L::dp);
  bf16* dSs = reinterpret_cast<bf16*>(smem + L::ds);
  float* dQs = reinterpret_cast<float*>(smem + L::acc0);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int g = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * kRows;
  const int kv_len = min(max(a.kv_lens[b], 0), a.Lk);

  load_rows<D>(Qs, [&](int r) -> const bf16* {
    const int t = q0 + r;
    return t < a.Lq ? a.q + b * a.sqb + t * a.sqt + h * a.sqh : nullptr;
  });
  load_rows<D>(dOs, [&](int r) -> const bf16* {
    const int t = q0 + r;
    return t < a.Lq ? a.dO + b * a.sdob + t * a.sdot + h * a.sdoh : nullptr;
  });
  load_row_stats(a, bh, q0, lse_s, delta_s);
  zero_acc<D>(dQs);

  int k_hi = kv_len;
  if (a.causal) k_hi = min(k_hi, min(q0 + kRows, a.Lq));   // stop at the diagonal
  const int n_tiles = (k_hi + kCols - 1) / kCols;
  __syncthreads();

  for (int j = 0; j < n_tiles; ++j) {
    const int key0 = j * kCols;
    load_rows<D>(Ks, [&](int r) -> const bf16* {
      const int key = key0 + r;
      return key < k_hi ? a.k + b * a.skb + key * a.skt + g * a.skh : nullptr;
    });
    load_rows<D>(Vs, [&](int r) -> const bf16* {
      const int key = key0 + r;
      return key < k_hi ? a.v + b * a.svb + key * a.svt + g * a.svh : nullptr;
    });
    __syncthreads();
    scores_tile<D>(Qs, Ks, Ss, warp);     // S  = Q K^T  (warp's 16 rows)
    scores_tile<D>(dOs, Vs, dPs, warp);   // dP = dO V^T
    __syncwarp();
    for (int i = 0; i < 16; ++i) {
      const int r = warp * 16 + i;
      const int t = q0 + r;
      const float lse_r = lse_s[r], delta_r = delta_s[r];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const int key = key0 + c;
        const bool valid = t < a.Lq && key < kv_len && (!a.causal || key <= t);
        const float p = valid ? __expf(Ss[r * Ld<D>::s + c] * a.scale - lse_r) : 0.f;
        const float ds = p * (dPs[r * Ld<D>::s + c] - delta_r) * a.scale;
        dSs[r * Ld<D>::p + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    pv_tile<D>(dSs, Ks, dQs, warp);       // dQ += dS K
    __syncthreads();
  }
  store_acc<D>(dQs, [&](int r) -> bf16* {
    const int t = q0 + r;
    return t < a.Lq ? a.dq + b * a.sdqb + t * a.sdqt + h * a.sdqh : nullptr;
  });
}

template <typename Kernel>
static int launch(Kernel kernel, dim3 grid, const BwdArgs& a, void* stream) {
  const size_t smem = BwdSmem<128>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

static bool supported(int H, int Hkv, int D) {
  return D == 128 && Hkv > 0 && H % Hkv == 0;
}

}  // namespace socio

extern "C" int socio_flash_train_dq_bf16(
    const void* q, const void* k, const void* v, const void* dO, const void* lse,
    const void* delta, void* dq, const void* kv_lens,
    int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sdob, long long sdot, long long sdoh,
    long long sdqb, long long sdqt, long long sdqh,
    int causal, float scale, void* stream) {
  using namespace socio;
  if (!supported(H, Hkv, D)) return (int)cudaErrorInvalidValue;
  BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            static_cast<bf16*>(dq), static_cast<const int*>(kv_lens),
            Lq, Lk, H, Hkv, causal,
            sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sdob, sdot, sdoh,
            sdqb, sdqt, sdqh, scale};
  return launch(flash_train_dq_kernel<128>, dim3((Lq + kRows - 1) / kRows, B * H), a, stream);
}

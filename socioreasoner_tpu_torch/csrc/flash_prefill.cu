// Causal prefill attention with GQA folded into the CTA.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/flash_attention.py
// `_attn_kernel` (reached through `flash_attention`). Semantics kept: q
// (B, Lq, H, D) against k/v (B, Lk, Hkv, D); one valid KV length per batch row
// (contiguous-prefix mask); causal or full; the D^-0.5 scale on the f32
// logits; bf16 matmul inputs with f32 accumulation; rows with no valid key
// give 0.
//
// What bounds it on the H100: at the engine's prefill shapes (B = 1-4,
// L = 2048, 16 q / 2 kv heads, D = 128) it is tensor-core work, ~34 GFLOP per
// layer causal at B = 2, while K/V of one (batch, kv head) is only 1 MiB and sits in
// L2. The design therefore spends its effort on the tensor cores (bf16 WMMA for
// both products) and on never computing above the diagonal: a CTA stops at the
// last key its last query row may see. GQA is folded as in the Pallas grid:
// one CTA serves all `rep` q heads of one kv head, so its 64 query rows are
// 64 / rep tokens x rep heads and each K/V tile feeds rep heads at once.
// The (B, L, H, D) tensors are read through their strides, so the TPU
// wrapper's transposes are gone.
#include "attention_tile.cuh"

namespace socio {

struct PrefillArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const int* kv_lens;  // (B,)
  int Lq, Lk, Hkv, rep, causal;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(PrefillArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = TileSmem<D>;
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* m_s = reinterpret_cast<float*>(smem + L::m);
  float* l_s = reinterpret_cast<float*>(smem + L::l);

  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y / a.Hkv;
  const int g = blockIdx.y % a.Hkv;
  const int rep = a.rep;
  const int toks = kRows / rep;           // query tokens in this CTA
  const int t0 = blockIdx.x * toks;
  const int kv_len = min(max(a.kv_lens[b], 0), a.Lk);

  // query row r = token t0 + r / rep, q head g * rep + r % rep (HF GQA order)
  load_rows<D>(Qs, [&](int r) -> const bf16* {
    const int t = t0 + r / rep;
    if (t >= a.Lq) return nullptr;
    return a.q + b * a.sqb + t * a.sqt + (g * rep + r % rep) * a.sqh;
  });
  init_state<D>(Os, m_s, l_s);

  int k_hi = kv_len;
  if (a.causal) k_hi = min(k_hi, min(t0 + toks, a.Lq));   // early exit at the diagonal
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
    scores_tile<D>(Qs, Ks, Ss, warp);
    __syncwarp();
    softmax_tile<D>(Ss, Ps, Os, m_s, l_s, warp, a.scale, [&](int r, int c) {
      const int t = t0 + r / rep;
      const int key = key0 + c;
      return t < a.Lq && key < kv_len && (!a.causal || key <= t);
    });
    __syncwarp();
    pv_tile<D>(Ps, Vs, Os, warp);
    __syncthreads();
  }
  __syncthreads();
  write_rows<D>(Os, l_s, [&](int r) -> bf16* {
    const int t = t0 + r / rep;
    if (t >= a.Lq) return nullptr;
    return a.o + b * a.sob + t * a.sot + (g * rep + r % rep) * a.soh;
  });
}

template <int D>
static int launch_prefill(const PrefillArgs& a, int B, cudaStream_t stream) {
  const size_t smem = TileSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_prefill_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int toks = kRows / a.rep;
  dim3 grid((a.Lq + toks - 1) / toks, B * a.Hkv);
  flash_prefill_kernel<D><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace socio

extern "C" int socio_flash_prefill_bf16(
    const void* q, const void* k, const void* v, void* o, const void* kv_lens,
    int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh,
    int causal, float scale, void* stream) {
  using namespace socio;
  if (Hkv <= 0 || H % Hkv != 0 || kRows % (H / Hkv) != 0) return (int)cudaErrorInvalidValue;
  PrefillArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                static_cast<const bf16*>(v), static_cast<bf16*>(o),
                static_cast<const int*>(kv_lens), Lq, Lk, Hkv, H / Hkv, causal,
                sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80: return launch_prefill<80>(a, B, s);
    case 128: return launch_prefill<128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

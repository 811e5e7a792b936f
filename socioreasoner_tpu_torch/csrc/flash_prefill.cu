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
// wrapper's transposes are gone. The CTA body (gqa_attention_cta) is shared
// with the training forward, flash_train_fwd.cu.
#include "attention_tile.cuh"

namespace socio {

template <int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(GqaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  gqa_attention_cta<D>(a, smem);
}

template <int D>
static int launch_prefill(const GqaArgs& a, int B, cudaStream_t stream) {
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
  GqaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o), nullptr,
            static_cast<const int*>(kv_lens), Lq, Lk, Hkv, H / Hkv, causal,
            sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 80: return launch_prefill<80>(a, B, s);
    case 128: return launch_prefill<128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Training forward: causal GQA attention plus the per-row log-sum-exp.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/flash_attention_bwd.py
// `_fwd_kernel` (reached through `_fwd` under the custom VJP
// `flash_attention_trainable`). Semantics kept: q (B, L, H, D) against k/v
// (B, L, Hkv, D) with K/V heads repeated to all H q heads; one valid KV length
// per batch row; causal by sequence index; the D^-0.5 scale on the f32
// logits; bf16 matmul inputs with f32 accumulation; lse = m + log(l) in f32.
// A row with kv_len = 0 gives out 0 and lse -1e30; query rows >= kv_len still
// attend to the keys < kv_len.
//
// What bounds it on the H100: at the train shape (B = 4, L = 2304, 16 q / 2
// kv heads, D = 128) one causal layer is ~87 GFLOP against ~85 MB of q, k, v,
// out and lse traffic, so it is tensor-core work by three orders of magnitude.
// It runs the same CTA as the prefill kernel (gqa_attention_cta in
// attention_tile.cuh): the repeat of K/V to all heads is folded into the grid
// (one CTA serves the 8 q heads of a kv head, so each K/V tile read feeds 8
// heads), the causal loop stops at the CTA's last token, and the tensors are
// read through their (B, L, H, D) strides, so the TPU wrapper's repeat,
// transposes and padding are gone. The only addition is the lse row it
// writes to (B, H, L) for the two backward kernels (flash_train_bwd.cu).
#include "attention_tile.cuh"

namespace socio {

template <int D>
__global__ void __launch_bounds__(kThreads) flash_train_fwd_kernel(GqaArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  gqa_attention_cta<D>(a, smem);
}

}  // namespace socio

extern "C" int socio_flash_train_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_lens,
    int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh,
    int causal, float scale, void* stream) {
  using namespace socio;
  if (D != 128 || Hkv <= 0 || H % Hkv != 0 || kRows % (H / Hkv) != 0)
    return (int)cudaErrorInvalidValue;
  GqaArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
            static_cast<const bf16*>(v), static_cast<bf16*>(o), static_cast<float*>(lse),
            static_cast<const int*>(kv_lens), Lq, Lk, Hkv, H / Hkv, causal,
            sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh, scale};
  const size_t smem = TileSmem<128>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_train_fwd_kernel<128>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int toks = kRows / a.rep;
  dim3 grid((Lq + toks - 1) / toks, B * Hkv);
  flash_train_fwd_kernel<128><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

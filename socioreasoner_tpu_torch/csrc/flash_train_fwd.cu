// Training forward: causal GQA attention plus the per-row log-sum-exp.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/flash_attention_bwd.py
// `_fwd_kernel` (reached through `_fwd` under the custom VJP
// `flash_attention_trainable`). Semantics kept: q (B, L, H, D) against k/v
// (B, L, Hkv, D) with K/V heads repeated to all H q heads; one valid KV length
// per batch row; causal by sequence index; the D^-0.5 scale on the f32
// logits; bf16 matmul inputs with f32 accumulation; out in q's dtype and
// lse = m * scale + ln(l) in f32, (B, H, L). A row with no valid key gives out
// 0 and lse -1e30 (the Pallas NEG_INF); query rows >= kv_len still attend to
// the keys < kv_len.
//
// What bounds it on the H100: at the train shape (B = 4, L = 2304, 16 q / 2
// kv heads, D = 128, kv lengths 2304/2080/1000/1) it does 5.8e10 FLOP of
// tensor-core work (0.059 ms at the bf16 peak) against ~85 MB of q, k, v,
// out and lse (0.025 ms at the memory rate): tensor-core bound.
//
// The design: this is kernel 2's instance of the Hopper CTA
// (attention_sm90.cuh, launched by launch_gqa) with an lse epilogue --
// persistent warp-specialised CTAs over (batch row, kv head, token tile)
// items, the last token tiles first and the (batch row, kv head) order
// rotated per token tile, each item reading its kv_len on the device
// (prefill_k_tiles) and stopping at its last token's diagonal; one producer
// warp keeps TMA loads of Q and of the K/V ring in flight; two consumer
// warpgroups run S = Q K^T and O += P V on wgmma with S, P and O in
// registers. The CTA keeps m as a raw logit and sums exp2 with the scale
// folded into log2(e), so the epilogue converts back to natural-log units;
// one lane of each quad writes its row's lse. The GQA fold reads each K/V
// tile once for the rep = 8 q heads of a kv head (any rep up to 128: a
// rep that does not divide 128 leaves rows of the 128-row tile idle), so
// the TPU wrapper's repeat, transposes and padding are gone. Head dims
// follow kernel 2's rule: any multiple of 8 up to 256 on the 64-, 80-, 128-
// or 256-column instance that covers it, the tail zero-filled by TMA and
// never stored, a wider one on the sliced CTA in column slices of 256 (slice
// 0 writes the lse); the host pads other head dims to a multiple of 8.
#include "attention_sm90.cuh"

extern "C" int socio_flash_train_fwd_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* kv_lens,
    int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh,
    int causal, float scale, void* stream) {
  // kernel 2's instances of the CTA (64, 80, 128 and 256 columns) serve
  // every head dim that is a multiple of 8 up to 256; launch_gqa refuses the
  // rest
  return socio90::launch_gqa(q, k, v, o, static_cast<float*>(lse), kv_lens, B, Lq, Lk, H, Hkv,
                             D, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh, sob, sot, soh,
                             causal, scale, static_cast<cudaStream_t>(stream));
}

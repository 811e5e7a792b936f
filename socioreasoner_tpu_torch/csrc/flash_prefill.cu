// Causal prefill attention with GQA folded into the CTA.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/flash_attention.py
// `_attn_kernel` (reached through `flash_attention`). Semantics kept: q
// (B, Lq, H, D) against k/v (B, Lk, Hkv, D); one valid KV length per batch row
// (contiguous-prefix mask); causal or full; the D^-0.5 scale on the f32
// logits; bf16 matmul inputs with f32 accumulation; rows with no valid key
// give 0; every row < Lq is written.
//
// What bounds it on the H100: at the engine's prefill shapes (B = 1-4,
// L = 2048, 16 q / 2 kv heads, D = 128) it is tensor-core work, ~17 GFLOP per
// layer causal at B = 2 (17 us at the bf16 peak), while its 38 MB of
// Q/K/V/O take 11 us at the memory rate. Instances of 64 (Qwen2.5-0.5B/1.5B,
// Llama-3.2-1B/3B), 80 (the ViT's, H2O-Danube2), 128 and 256 (Falcon3-7B)
// columns are compiled; a head dim d that is a multiple of 8 up to 256 runs
// on the smallest instance of at least d columns (H2O-Danube3-500M's 96 and
// -4B's 120 on the 128 one, 136-248 on the 256 one), its tail columns
// zero-filled by TMA and never stored (attention_sm90.cuh); the host pads
// other head dims (OpenLLaMA-3B's 100) to a multiple of 8 first. A wider d
// runs on the sliced CTA in ceil(d / 256) column slices (Falcon3-7B's widths
// regrouped as 6/2 x 512 or 8/2 x 384).
//
// The design (attention_sm90.cuh): GQA is folded as in the Pallas grid, so a
// 128-row work item is floor(128 / rep) tokens x the rep q heads of one kv
// head -- the rep heads are contiguous in (B, L, H, D), so one 4-D TMA box
// (64 columns x rep heads x floor(128 / rep) tokens) lands them in that
// order -- and every K/V tile feeds all rep heads. Any rep up to 128 is
// taken: where rep does not divide 128 the rows past rep * floor(128 / rep)
// stay idle (zero, never stored). Items are (batch, kv head, token tile),
// the last token tiles first; each reads its batch row's kv_len on the
// device, stops at the last key its last token may see (tiles above the
// diagonal are never loaded) and masks only the tiles that reach past its
// first token or past kv_len. TMA fills rows past Lq or Lk with zeros; the
// mask still decides. Persistent warp-specialised CTAs, TMA into a
// multi-stage mbarrier ring, S/P/O in registers through wgmma. The training
// forward (flash_train_fwd.cu) launches the same instance with an lse output.
#include "attention_sm90.cuh"

namespace socio90 {

int launch_gqa(const void* q, const void* k, const void* v, void* o, float* lse,
               const void* kv_lens, int B, int Lq, int Lk, int H, int Hkv, int D,
               long long sqb, long long sqt, long long sqh, long long skb, long long skt,
               long long skh, long long svb, long long svt, long long svh,
               long long sob, long long sot, long long soh, int causal, float scale,
               cudaStream_t stream) {
  // the instance that serves D (Layout<D> admits 64k and 64k + 16 columns)
  const int inst = head_dim_instance(kGqaDims, D);
  if (Hkv <= 0 || H % Hkv != 0 || H / Hkv > kBM || inst == 0)
    return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  const int toks = kBM / rep;
  FwdParams p{};
  p.q_rows = rep * toks;
  p.d = D;
  p.slices = head_dim_slices(D);
  p.o = static_cast<bf16*>(o);
  p.sob = sob;
  p.sot = sot;
  p.soh = soh;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.lse = lse;
  p.B = B;
  p.Lq = Lq;
  p.Lk = Lk;
  p.Hkv = Hkv;
  p.rep = rep;
  p.causal = causal;
  p.n_ttiles = (Lq + toks - 1) / toks;
  p.n_items = p.n_ttiles * B * Hkv;
  // (D, heads, tokens, B) views; q boxes of rep heads x floor(128 / rep) tokens,
  // k/v boxes of one kv head x a stage's keys (128, or 64 at 256 columns),
  // each inst columns wide
  const long long qdims[4] = {D, H, Lq, B}, kdims[4] = {D, Hkv, Lk, B};
  const long long qs[4] = {1, sqh, sqt, sqb}, ks[4] = {1, skh, skt, skb},
                  vs[4] = {1, svh, svt, svb};
  const int keys = stage_keys(inst);
  int qbox[4] = {0, rep, toks, 1}, kbox[4] = {0, 1, keys, 1}, vbox[4] = {0, 1, keys, 1};
  int rc = encode_pair(&p.q_main, &p.q_tail, q, 4, qdims, qs, qbox, inst);
  if (rc == 0) rc = encode_pair(&p.k_main, &p.k_tail, k, 4, kdims, ks, kbox, inst);
  if (rc == 0) rc = encode_pair(&p.v_main, &p.v_tail, v, 4, kdims, vs, vbox, inst);
  if (rc != 0) return rc;
  if (p.slices > 1) return launch_sliced<false>(p, stream);
  switch (inst) {
    case 64: return launch_width<64, false>(p, stream);
    case 80: return launch_width<80, false>(p, stream);
    case 128: return launch_width<128, false>(p, stream);
    case 256: return launch_width<256, false>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace socio90

extern "C" int socio_flash_prefill_bf16(
    const void* q, const void* k, const void* v, void* o, const void* kv_lens,
    int B, int Lq, int Lk, int H, int Hkv, int D,
    long long sqb, long long sqt, long long sqh,
    long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh,
    long long sob, long long sot, long long soh,
    int causal, float scale, void* stream) {
  return socio90::launch_gqa(q, k, v, o, nullptr, kv_lens, B, Lq, Lk, H, Hkv, D, sqb, sqt, sqh,
                             skb, skt, skh, svb, svt, svh, sob, sot, soh, causal, scale,
                             static_cast<cudaStream_t>(stream));
}

// The k-tile bounds the kernel gives token tile t_tile, by the device's own
// formula run on the host: out = {k tiles visited, k tiles left unmasked}.
extern "C" int socio_prefill_tile_bounds(int t_tile, int kv_len, int Lq, int Lk, int rep,
                                         int causal, void* out) {
  using namespace socio90;
  if (rep <= 0 || rep > kBM) return (int)cudaErrorInvalidValue;
  const int toks = kBM / rep;
  const int2 n = prefill_k_tiles(t_tile * toks, toks, kv_len, Lq, Lk, causal);
  static_cast<int*>(out)[0] = n.x;
  static_cast<int*>(out)[1] = n.y;
  return 0;
}

// GQA work item `item` of kernels 2, 4 and 5 at (B, Lq, Hkv, rep), by the
// device's own formula run on the host: out = {batch row, kv head, first
// token, tokens}.
extern "C" int socio_gqa_item(int item, int B, int Lq, int Hkv, int rep, void* out) {
  using namespace socio90;
  if (rep <= 0 || rep > kBM || B <= 0 || Hkv <= 0) return (int)cudaErrorInvalidValue;
  const int toks = kBM / rep;
  const int3 w = gqa_item(item, B, Hkv, (Lq + toks - 1) / toks, toks);
  int* o = static_cast<int*>(out);
  o[0] = w.x;
  o[1] = w.y;
  o[2] = w.z;
  o[3] = toks;
  return 0;
}

// The instance (columns of the tiles) that kernel `kernel` (1, 2, 4, 5 or 6)
// runs head dim d on, by the kernels' own formula: 0 where none serves d
// (the host's copy, ops/flash_attention.py head_dim_plan, is held to it).
extern "C" int socio_head_dim_instance(int kernel, int d) {
  using namespace socio90;
  switch (kernel) {
    case 1: return head_dim_instance(kSegDims, d);
    case 2:
    case 4: return head_dim_instance(kGqaDims, d);
    case 5:
    case 6: return head_dim_instance(kBwdDims, d);
    default: return 0;
  }
}

// The column slices of 256 that kernels 1, 2 and 4-6 run head dim d in (1 up
// to 256), 0 where no instance serves d: the rule of head_dim_slices, which
// every entry point applies (the host's copy, head_dim_plan, is held to it).
extern "C" int socio_head_dim_slices(int kernel, int d) {
  return socio_head_dim_instance(kernel, d) == 0 ? 0 : socio90::head_dim_slices(d);
}

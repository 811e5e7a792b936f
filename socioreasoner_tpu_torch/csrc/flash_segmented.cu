// Segment-id attention over a packed ViT sequence.
//
// Replaces the Pallas kernel socioreasoner_tpu/ops/flash_attention.py
// `_seg_kernel` (reached through `flash_attention_segmented`). Semantics kept:
// q, k, v (S, H, D), non-causal; query i sees key j iff seg[i] == seg[j];
// padded rows and keys carry the sentinels -1 / -2 and never match; the
// D^-0.5 scale on the f32 logits; bf16 matmul inputs with f32 accumulation;
// rows with no valid key give 0; every row < S is written.
//
// What bounds it on the H100, at two 756x756 images (S = 5832, 16 heads,
// D = 80): the four full-attention layers are tensor-core work (~87 GFLOP of
// block-diagonal attention each, 88 us at the bf16 peak); the 28 window
// layers (windows of 64, 48, 36 patches) are memory-bound (59.7 MB of
// Q/K/V/O each, 17.8 us at 3.35 TB/s) and do almost no arithmetic. Instances
// of 80 and 128 columns; any head dim that is a multiple of 8 up to 128 runs
// on the smaller one that covers it (attention_sm90.cuh).
//
// The design (attention_sm90.cuh): persistent warp-specialised CTAs, one per
// SM, walk a work list of (head, q tile) items that the wrapper builds on the
// host from the segment ids (ops/flash_attention.py seg_tile_plan; the ViT
// builds one plan per id array for all its layers). A q tile starts at a
// segment start and packs whole segments up to 128 rows, so a window
// layer's tile needs one 128-key tile holding
// exactly its own keys; a longer segment (a full layer's image) is cut into
// 128-row tiles that each walk the whole segment, and the k tiles inside it
// are evaluated without a mask. The producer warp streams Q/K/V with TMA, so
// a window layer's next item loads while the current one computes; S, P and
// O stay in registers (wgmma). For arbitrary ids the plan visits every k
// tile and the mask alone decides (the dense-safe path).
#include "attention_sm90.cuh"

extern "C" int socio_flash_segmented_bf16(
    const void* q, const void* k, const void* v, void* o, const void* seg,
    const void* work, const void* tiles, int S, int H, int D, int n_items,
    long long sqt, long long sqh, long long skt, long long skh,
    long long svt, long long svh, long long sot, long long soh,
    float scale, void* stream) {
  using namespace socio90;
  // the instance that serves D: 80 or 128 columns
  const int inst = head_dim_instance(kSegDims, D);
  if (inst == 0) return (int)cudaErrorInvalidValue;
  FwdParams p{};
  p.d = D;
  p.o = static_cast<bf16*>(o);
  p.sot = sot;
  p.soh = soh;
  p.n_items = n_items;
  p.q_rows = kBM;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.seg = static_cast<const int*>(seg);
  p.work = static_cast<const int*>(work);
  p.tiles = static_cast<const int4*>(tiles);
  p.S = S;
  // (D, H, S) views of q, k, v; boxes of 1 head x 128 rows
  const long long dims[3] = {D, H, S};
  const long long qs[3] = {1, sqh, sqt}, ks[3] = {1, skh, skt}, vs[3] = {1, svh, svt};
  int qbox[3] = {0, 1, kBM}, kbox[3] = {0, 1, kBN}, vbox[3] = {0, 1, kBN};
  int rc = encode_pair(&p.q_main, &p.q_tail, q, 3, dims, qs, qbox, inst);
  if (rc == 0) rc = encode_pair(&p.k_main, &p.k_tail, k, 3, dims, ks, kbox, inst);
  if (rc == 0) rc = encode_pair(&p.v_main, &p.v_tail, v, 3, dims, vs, vbox, inst);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (inst) {
    case 80: return launch_width<80, true>(p, s);
    case 128: return launch_width<128, true>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
